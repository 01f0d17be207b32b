"""The EXP epigraph of the port (``elementwise.epi_exp``, K8's plain version
and its dispatch) against the JAX package's ``epi_exp``, on the CPU in
float64, and the dispatch to K8 (``ops/kernels/epi_exp.py``,
``csrc/epi_exp.cu``), which runs on the card only
(``tests/test_torch_cuda.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_epi_exp.py -q -p no:cacheprovider
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ops.prox import elementwise as jew
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ops.kernels import epi_exp as k8
from epsilon_tpu_torch.ops.prox import elementwise as ew
from epsilon_tpu_torch.ops.prox import registry as reg

# |v| and |s| up to 10: both packages run the same 40 widening and 25
# Newton steps from the same start and solve every element; they differ
# only in the rounding of exp and log, a few ulps (4e-16 at 4,000
# elements).  Held to RTOL on every element, ATOL where x is near 0.
RTOL, ATOL = 1e-10, 1e-12
# |v| of 30-60 and |s| up to e^60: 25 Newton steps leave about a quarter of
# the active elements short of the root in both packages (a relative
# residual of g up to 2), and there the iterates follow those ulps: on 0.6-0.7 %
# of the elements the two stop up to 1e-8 apart (the reference's count; the
# watch list in PERF.md).  The elements both solve (relative residual
# <= FAR_SOLVED) are held to FAR_RTOL; at most FAR_ONE_SIDED of the
# elements are solved by one package alone (0.2 % here) and at most
# FAR_APART differ by more than FAR_RTOL, by at most FAR_GAP.
FAR_SOLVED = 1e-12
FAR_RTOL = 1e-9
FAR_ONE_SIDED = 0.01
FAR_APART = 0.02
FAR_GAP = 1e-7


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _both(v, s):
    """``(x, t)`` of the port's plain version and of the JAX package, as
    float64 numpy arrays of the joint shape."""
    s_t = s if isinstance(s, float) else _t(s)
    x, t = (a.numpy() for a in ew.epi_exp_reference(_t(v), s_t))
    xj, tj = (np.asarray(a) for a in jew.epi_exp(jnp.asarray(v), jnp.asarray(s)))
    return (x, t), (xj, tj)


def _near_inputs(n, seed):
    """v and s uniform over +-10: inactive elements (e^v <= s), active ones
    and s <= 0."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-10.0, 10.0, n), rng.uniform(-10.0, 10.0, n)


@pytest.mark.parametrize("s_kind", ["per_element", "number", "tensor_0d"])
@pytest.mark.parametrize("n", [1, 257, 4000])
def test_epi_exp_reference_matches_jax(n, s_kind):
    v, s = _near_inputs(n, n)
    if s_kind != "per_element":
        # one s for every element, from each of a few values: mostly active
        # elements, and inactive ones where v <= log s
        for s0 in (-3.0, 0.0, 0.5, 4.0, 9.5):
            p = _t(s0) if s_kind == "tensor_0d" else s0
            x, t = (a.numpy() for a in ew.epi_exp_reference(_t(v), p))
            xj, tj = (np.asarray(a) for a in jew.epi_exp(jnp.asarray(v), s0))
            np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(t, tj, rtol=RTOL, atol=ATOL)
        return
    (x, t), (xj, tj) = _both(v, s)
    inactive = np.exp(v) <= s
    assert n == 1 or 0 < inactive.sum() < n
    np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, tj, rtol=RTOL, atol=ATOL)
    # inactive elements come back as they went in
    assert np.array_equal(x[inactive], v[inactive]) and np.array_equal(t[inactive], s[inactive])


def test_epi_exp_reference_batch_and_broadcast_s_match_jax():
    """A stacked row's (rows, d) with s of the same shape (the meshed
    solver's stacked epigraph) and s broadcast along the rows."""
    rng = np.random.RandomState(11)
    v = rng.uniform(-10.0, 10.0, (4, 50))
    for s in (rng.uniform(-10.0, 10.0, (4, 50)), rng.uniform(-10.0, 10.0, 50)):
        (x, t), (xj, tj) = _both(v, s)
        assert x.shape == t.shape == v.shape
        np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t, tj, rtol=RTOL, atol=ATOL)


def _far_inputs(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.uniform(30.0, 60.0, n) * rng.choice([-1.0, 1.0], n)
    s = np.exp(rng.uniform(0.0, 60.0, n)) * rng.choice([-1.0, 1.0, 1.0], n)
    return v, s


def _residual(x, v, s):
    """|g(x)| relative to the scale of its terms."""
    ex = np.exp(x)
    return np.abs(x + ex * ex - s * ex - v) / np.maximum.reduce(
        [np.ones_like(ex), np.abs(v), ex * ex, np.abs(s) * ex])


@pytest.mark.parametrize("seed", [0, 1])
def test_epi_exp_reference_matches_jax_where_both_solve(seed):
    """|v| of 30-60 and |s| up to e^60 (see FAR_SOLVED)."""
    v, s = _far_inputs(4000, seed)
    (x, t), (xj, tj) = _both(v, s)
    inactive = np.exp(v) <= s
    solved_x = inactive | (_residual(x, v, s) <= FAR_SOLVED)
    solved_j = inactive | (_residual(xj, v, s) <= FAR_SOLVED)
    both = solved_x & solved_j
    assert both.mean() > 0.5 and (~both).sum() > 0
    np.testing.assert_allclose(x[both], xj[both], rtol=FAR_RTOL, atol=ATOL)
    np.testing.assert_allclose(t[both], tj[both], rtol=FAR_RTOL, atol=ATOL)
    assert (solved_x != solved_j).mean() <= FAR_ONE_SIDED
    gap = np.abs(x - xj) / np.maximum(1.0, np.abs(xj))
    assert (gap > FAR_RTOL).mean() <= FAR_APART and gap.max() <= FAR_GAP
    # every active element stays inside its bracket's upper end, in both
    for y in (x, xj):
        assert np.all(y[~inactive] <= v[~inactive])


def test_epi_exp_reference_special_values_match_jax():
    """Every pair of v and s in {NaN, +-inf, 0, -0, +-1e30, 1, -1, 50}: NaN
    exactly where the JAX package gives NaN, the other results (infinities
    included) within RTOL.  One pair differs by design: at s = -inf, g is
    +inf until e^x underflows, so the widening stops where exp first gives
    0, and XLA on the CPU flushes subnormals to zero (e^-728 is 0 there, a
    subnormal in PyTorch): where either x lies below the normal range of
    e^x, both must, with the same t."""
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0])
    v, s = (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))
    with np.errstate(all="ignore"):
        (x, t), (xj, tj) = _both(v, s)
    for a, b in ((x, xj), (t, tj)):
        assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(t, tj, rtol=RTOL, atol=ATOL, equal_nan=True)
    apart = ~np.isclose(x, xj, rtol=RTOL, atol=ATOL, equal_nan=True)
    tiny = np.log(np.finfo(np.float64).tiny)
    assert list(zip(v[apart], s[apart])) == [(-1.0, -np.inf)]
    assert np.all(x[apart] < tiny) and np.all(xj[apart] < tiny)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s_kind", ["number", "tensor_0d", "per_element"])
def test_epi_exp_cpu_dispatch_is_the_plain_version_bitwise(s_kind, dtype):
    v, s = _near_inputs(300, 4)
    v = torch.as_tensor(v, dtype=dtype)
    p = {"number": float(s[0]), "tensor_0d": torch.tensor(s[0], dtype=dtype),
         "per_element": torch.as_tensor(s, dtype=dtype)}[s_kind]
    before = k8.launches
    got = ew.epi_exp(v, p)
    want = ew.epi_exp_reference(v, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert k8.launches == before


def test_epi_exp_dispatch_and_entries_raise_without_a_card():
    before = k8.launches
    with pytest.raises(ValueError, match="CUDA"):
        ew.epi_exp(torch.zeros(4, device="meta"), 1.0)
    for entry in (k8.epi, k8.epi_full):
        with pytest.raises(ValueError, match="CUDA"):
            entry(torch.zeros(4, dtype=torch.float64), 1.0)
        with pytest.raises(ValueError, match="CUDA"):
            entry(torch.zeros(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32))
        with pytest.raises(TypeError):
            entry(torch.zeros(4, dtype=torch.int32), 1.0)
        with pytest.raises(TypeError):
            entry(torch.zeros(4, dtype=torch.float16), 1.0)
        with pytest.raises(TypeError):
            entry([1.0, 2.0], 1.0)
    assert k8.launches == before


def test_exp_epigraph_reaches_the_dispatch(monkeypatch):
    """The ``ProxKind.EXP`` entry of the registry projects through
    ``elementwise.epi_exp`` (so that on the card each call is one K8
    launch), and so does a solve under ``use_epigraph=False`` whose conic
    form holds EXP epigraphs (``max_softmax`` at the CPU library tests'
    size); on the CPU that is the plain version."""
    import torch_library_rows as rows
    from epsilon_tpu_torch.ir import ProxKind
    calls = []
    real = ew.epi_exp_reference

    def spy(v, s):
        calls.append(tuple(v.shape))
        return real(v, s)

    monkeypatch.setattr(ew, "epi_exp_reference", spy)
    v, s = (torch.as_tensor(a) for a in _near_inputs(20, 2))
    x, t = reg.KERNELS[ProxKind.EXP].epi(v, s)
    assert calls == [(20,)]
    assert all(torch.equal(a, b) for a, b in zip((x, t), real(v, s)))
    from epsilon_tpu_torch.problems import benchmark
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == "max_softmax")
    prob = benchmark.ProblemInstance("max_softmax", inst.create,
                                     rows.SMALL["max_softmax"]).create_problem()
    prob.solve(use_epigraph=False, max_iterations=3)
    assert len(calls) > 1


@pytest.mark.parametrize("a,b", [((2, 3), (3,)), ((2, 1), (1, 5)), ((), (4,)), ((7,), (7,)),
                                 ((3, 1, 2), (4, 1)), ((2, 3), (4,))])
def test_broadcast_shape_is_torch_rule(a, b):
    """The kernels' argument helpers broadcast by numpy's rule, which is
    torch's; a pair that does not broadcast raises ValueError."""
    from epsilon_tpu_torch.ops.kernels import _rows
    try:
        want = tuple(torch.broadcast_shapes(a, b))
    except RuntimeError:
        with pytest.raises(ValueError):
            _rows.broadcast_shape(a, b)
        return
    assert _rows.broadcast_shape(a, b) == want


def test_kernel_arguments_do_not_import_sympy():
    """K6's and K8's argument checks (``_rows.element_args``) and K3-K5's
    (``_rows.out_shape``) broadcast through ``_rows.broadcast_shape``, not
    ``torch.broadcast_shapes``, whose first call imports sympy: 3-5 s in
    each fresh process of phase 9 on the card's host.  In a fresh
    interpreter neither helper imports it, and the module calls no
    ``torch.broadcast_shapes``."""
    import inspect
    import subprocess
    import sys
    from epsilon_tpu_torch.ops.kernels import _rows
    assert "torch.broadcast_shapes(" not in inspect.getsource(_rows)
    code = ("import sys, torch\n"
            "from epsilon_tpu_torch.ops.kernels import _rows\n"
            "assert 'sympy' not in sys.modules\n"
            "_rows.out_shape('f', 's', (4,), (4,))\n"
            "_rows.broadcast_shape((2, 1), (1, 3))\n"
            "print('sympy' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False"
