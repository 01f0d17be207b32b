"""The port's last elementwise prox loops against the JAX package, on the
CPU in float64: the SUM_KL_DIV, SUM_INV_POS, SUM_EXP and SUM_NEG_ENTR
proxes (``elementwise.prox_sum_kl_div_reference``,
``prox_sum_inv_pos_reference``, ``prox_sum_exp_reference``,
``prox_sum_neg_entr_reference``: the plain versions of K9
``csrc/sum_kl_div.cu``, K10 ``csrc/sum_inv_pos.cu`` and K11
``csrc/w_log_w.cu``), the port's ``eval_prox`` of the three frontend kinds
that reach K10 and K11, and the dispatch, which on a CPU tensor takes the
plain version and on a CUDA tensor launches the kernel (the kernels run on
the card only: ``tests/test_torch_cuda.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_elementwise_loops.py -q -p no:cacheprovider
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu.ops.prox import elementwise as jew
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ops.kernels import _rows
from epsilon_tpu_torch.ops.kernels import sum_inv_pos as k10
from epsilon_tpu_torch.ops.kernels import sum_kl_div as k9
from epsilon_tpu_torch.ops.kernels import w_log_w as k11
from epsilon_tpu_torch.ops.prox import elementwise as ew
from epsilon_tpu_torch.ops.prox import newton_epi as ne
from epsilon_tpu_torch.ops.prox import registry as reg

# Both packages run the same loops from the same starts and differ only in
# the rounding of log, exp and the cube root (jnp.cbrt against the port's
# sign(x) |x| ** (1/3)).  On the near range (|v| up to 10, lam over
# 1e-3..1e3) and on the far one (|v| up to 60, lam over 1e-6..1e6) the
# one-argument kinds agree within 7e-16 relative on every element, the KL
# prox within 5e-11 on the near range: held to RTOL on every element.
RTOL, ATOL = 1e-9, 1e-12
# The KL prox on the far range: about a quarter of the elements have their
# root below the bracket's lower end (u well below 0: x = 0 lies outside
# r >= eps), where both packages end at that end; the others both solve
# (a relative residual of g at most KL_SOLVED).  Where lam is near 1e-6
# and v < 0, y = lam r + v - lam cancels, and on 0.1-0.5 % of the elements
# the two packages end up to 2e-8 apart: at most KL_APART of the elements
# differ by more than RTOL, by at most KL_GAP; no element is solved by one
# package alone.
KL_SOLVED = 1e-12
KL_APART = 0.01
KL_GAP = 1e-7

ONE_ARG = {
    "sum_exp": (ew.prox_sum_exp_reference, jew.prox_sum_exp),
    "sum_neg_entr": (ew.prox_sum_neg_entr_reference, jew.prox_sum_neg_entr),
    "sum_inv_pos": (ew.prox_sum_inv_pos_reference, jew.prox_sum_inv_pos),
}
# (v range, lam exponents)
RANGES = {"near": (10.0, 3.0), "far": (60.0, 6.0)}
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0])
SPECIAL_LAM = np.array([np.nan, np.inf, 0.0, 1e-30, 1.0, 1e30, -1.0])


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _lam(lam, kind):
    """lam as the plain version gets it: a number, a 0-d tensor, one an
    element, or one a row of a (rows, n) batch."""
    if kind == "number":
        return float(lam.flat[0])
    if kind == "tensor_0d":
        return _t(lam.flat[0])
    if kind == "per_row":
        return _t(lam[:, :1])
    return _t(lam)


def _inputs(n, vr, le, seed, rows=1):
    rng = np.random.RandomState(seed)
    v = rng.uniform(-vr, vr, (rows, n))
    lam = 10.0 ** rng.uniform(-le, le, (rows, n))
    return v, lam


@pytest.mark.parametrize("lam_kind", ["number", "tensor_0d", "per_element", "per_row"])
@pytest.mark.parametrize("span", list(RANGES))
@pytest.mark.parametrize("kind", list(ONE_ARG))
def test_one_argument_reference_matches_jax(kind, span, lam_kind):
    plain, jax_fn = ONE_ARG[kind]
    v, lam = _inputs(300, *RANGES[span], seed=len(kind), rows=4)
    if kind == "sum_inv_pos" and lam_kind == "per_row":
        # its plain version broadcasts lam to v's shape first, as the JAX
        # package's does
        lam = np.repeat(lam[:, :1], v.shape[1], axis=1)
    p = _lam(lam, lam_kind)
    x = plain(_t(v), p).numpy()
    pj = p if isinstance(p, float) else jnp.asarray(p.numpy())
    xj = np.asarray(jax_fn(jnp.asarray(v), pj))
    assert x.shape == xj.shape == v.shape and np.all(np.isfinite(x))
    np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", list(ONE_ARG))
def test_one_argument_reference_special_values_match_jax(kind):
    """Every pair of v in {NaN, +-inf, 0, -0, +-1e30, +-1, 50} and lam in
    {NaN, inf, 0, 1e-30, 1, 1e30, -1}: NaN exactly where the JAX package
    gives NaN, the other results (infinities included) within RTOL."""
    plain, jax_fn = ONE_ARG[kind]
    v, lam = (a.ravel() for a in np.meshgrid(SPECIAL, SPECIAL_LAM, indexing="ij"))
    with np.errstate(all="ignore"):
        x = plain(_t(v), _t(lam)).numpy()
        xj = np.asarray(jax_fn(jnp.asarray(v), jnp.asarray(lam)))
    assert np.array_equal(np.isnan(x), np.isnan(xj)) and np.isnan(x).any()
    np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL, equal_nan=True)


def _kl_inputs(n, vr, le, seed, rows=1):
    rng = np.random.RandomState(seed)
    u = rng.uniform(-vr / 2, vr, (rows, n))
    v = rng.uniform(-vr / 2, vr, (rows, n))
    lam = 10.0 ** rng.uniform(-le, le, (rows, n))
    return u, v, lam


def _kl_both(u, v, lam):
    p = lam if isinstance(lam, float) else _t(lam)
    x, y = (a.numpy() for a in ew.prox_sum_kl_div_reference(_t(u), _t(v), p))
    xj, yj = (np.asarray(a) for a in jew.prox_sum_kl_div(jnp.asarray(u), jnp.asarray(v),
                                                         jnp.asarray(lam)))
    return (x, y), (xj, yj)


def _kl_residual(x, y, u, v, lam):
    """|g(r)| at r = x / y, relative to the scale of its terms."""
    with np.errstate(all="ignore"):
        r = x / y
        terms = np.stack([lam * r * r, (v - lam) * r, -u, lam * np.log(r)])
        return np.abs(terms.sum(axis=0)) / np.maximum(1.0, np.abs(terms).max(axis=0))


@pytest.mark.parametrize("lam_kind", ["number", "per_element", "per_row"])
def test_kl_div_reference_matches_jax_near(lam_kind):
    u, v, lam = _kl_inputs(300, 10.0, 3.0, seed=3, rows=4)
    if lam_kind == "per_row":
        lam = np.repeat(lam[:, :1], u.shape[1], axis=1)
    lam = float(lam[0, 0]) if lam_kind == "number" else lam
    (x, y), (xj, yj) = _kl_both(u, v, lam)
    assert x.shape == y.shape == u.shape
    np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, yj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kl_div_reference_matches_jax_far(seed):
    """|u|, |v| up to 60 and lam over 1e-6..1e6 (see KL_SOLVED)."""
    u, v, lam = (a.ravel() for a in _kl_inputs(4000, 60.0, 6.0, seed))
    (x, y), (xj, yj) = _kl_both(u, v, lam)
    solved = _kl_residual(x, y, u, v, lam) <= KL_SOLVED
    solved_j = _kl_residual(xj, yj, u, v, lam) <= KL_SOLVED
    assert np.array_equal(solved, solved_j) and 0.5 < solved.mean() < 0.95
    gap = np.maximum(np.abs(x - xj) / np.maximum(1.0, np.abs(xj)),
                     np.abs(y - yj) / np.maximum(1.0, np.abs(yj)))
    assert (gap > RTOL).mean() <= KL_APART and gap.max() <= KL_GAP
    # the rest are bounded by the bracket: both end at its lower end, r =
    # (lam - v)/lam + eps where that exceeds eps, with g > 0 there
    eps = 1e-13
    lo = np.maximum((lam - v) / lam + eps, eps)
    for a, b in ((x, y), (xj, yj)):
        with np.errstate(all="ignore"):
            r = a / b
        rest = ~solved & (b != 0)
        np.testing.assert_allclose(r[rest], lo[rest], rtol=1e-6)


def test_kl_div_reference_special_values_match_jax():
    """Every pair of u and v in {NaN, +-inf, 0, -0, +-1e30, +-1, 50}, lam
    from {1e-30, 1, 1e30, inf, NaN, 0}: NaN where the JAX package gives
    NaN, the rest within RTOL."""
    u, v = (a.ravel() for a in np.meshgrid(SPECIAL, SPECIAL, indexing="ij"))
    for lam in (1e-30, 1.0, 1e30, np.inf, np.nan, 0.0):
        with np.errstate(all="ignore"):
            got, want = _kl_both(u, v, lam)
        for a, b in zip(got, want):
            assert np.array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)


# -- eval_prox of the frontend kinds that reach K10 and K11 --------------------

EVAL_N = 300
# name -> (build(ep, x), kind, make_v(rng), lam), inputs inside each kind's
# domain as chip_smoke.py's phase 8 (g) makes them
EVAL_PROX = {
    "sum_exp": (lambda ep, x: ep.sum_entries(ep.exp(x)), "SUM_EXP",
                lambda rng: rng.randn(EVAL_N) * 3.0, 0.6),
    "sum_neg_entr": (lambda ep, x: ep.sum_entries(-ep.entr(x)), "SUM_NEG_ENTR",
                     lambda rng: rng.randn(EVAL_N) * 3.0, 0.8),
    "sum_inv_pos": (lambda ep, x: ep.sum_entries(ep.power(x, -1)), "SUM_INV_POS",
                    lambda rng: np.abs(rng.randn(EVAL_N)) * 3.0 + 0.1, 0.5),
}


@pytest.mark.parametrize("name", list(EVAL_PROX))
def test_eval_prox_of_the_kernels_kinds_matches_jax(name, monkeypatch):
    """``eval_prox`` of ``sum_entries(exp(x))``, ``sum_entries(-entr(x))``
    and ``sum_entries(power(x, -1))`` in both packages, within 1e-8: the
    port's goes through the dispatch (on the CPU the plain version, on the
    card one launch of K11 or K10)."""
    build, kind, make_v, lam = EVAL_PROX[name]
    target = {"sum_exp": "prox_sum_exp_reference", "sum_neg_entr": "prox_sum_neg_entr_reference",
              "sum_inv_pos": "prox_sum_inv_pos_reference"}[name]
    real, calls = getattr(ew, target), []
    monkeypatch.setattr(ew, target, lambda v, l: calls.append(v.shape) or real(v, l))
    values = []
    for ep in (ej, et):
        v = make_v(np.random.RandomState(9))
        x = ep.Variable(EVAL_N)
        ep.eval_prox(build(ep, x), {x: v}, lam=lam, expected_kind=getattr(ep.ProxKind, kind))
        values.append(x.value.ravel())
    assert calls
    np.testing.assert_allclose(values[1], values[0], rtol=0, atol=1e-8)


# -- the dispatch -------------------------------------------------------------

ONE_ARG_DISPATCH = [
    ("sum_exp", ew.prox_sum_exp, ew.prox_sum_exp_reference, k11),
    ("sum_neg_entr", ew.prox_sum_neg_entr, ew.prox_sum_neg_entr_reference, k11),
    ("sum_inv_pos", ew.prox_sum_inv_pos, ew.prox_sum_inv_pos_reference, k10),
]
ENTRIES = [("sum_inv_pos", k10.prox), ("sum_inv_pos full", k10.prox_full),
           ("w_log_w exp", k11.prox_exp), ("w_log_w exp full", k11.prox_exp_full),
           ("w_log_w neg_entr", k11.prox_neg_entr),
           ("w_log_w neg_entr full", k11.prox_neg_entr_full)]


def _launches():
    return k9.launches, k10.launches, k11.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam_kind", ["number", "tensor_0d", "per_element"])
@pytest.mark.parametrize("kind,dispatch,plain,module", ONE_ARG_DISPATCH)
def test_cpu_dispatch_is_the_plain_version_bitwise(kind, dispatch, plain, module, lam_kind,
                                                   dtype):
    v, lam = _inputs(200, 10.0, 3.0, seed=5)
    v = torch.as_tensor(v, dtype=dtype)
    p = _lam(lam, lam_kind)
    p = p.to(dtype) if isinstance(p, torch.Tensor) else p
    before = _launches()
    assert torch.equal(dispatch(v, p), plain(v, p))
    assert _launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam_kind", ["number", "tensor_0d", "per_element"])
def test_kl_div_cpu_dispatch_is_the_plain_version_bitwise(lam_kind, dtype):
    u, v, lam = (torch.as_tensor(a, dtype=dtype) for a in _kl_inputs(200, 10.0, 3.0, seed=6))
    p = {"number": float(lam[0, 0]), "tensor_0d": lam[0, 0].clone(), "per_element": lam}[lam_kind]
    before = _launches()
    got, want = ew.prox_sum_kl_div(u, v, p), ew.prox_sum_kl_div_reference(u, v, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _launches() == before


@pytest.mark.parametrize("kind,dispatch,plain,module", ONE_ARG_DISPATCH)
def test_dispatch_raises_on_another_device(kind, dispatch, plain, module):
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        dispatch(torch.zeros(4, device="meta"), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ew.prox_sum_kl_div(torch.zeros(4, device="meta"), torch.zeros(4, device="meta"), 1.0)
    assert _launches() == before


@pytest.mark.parametrize("fname,entry", ENTRIES)
def test_one_argument_entries_raise_without_a_card_and_on_bad_types(fname, entry):
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        entry(torch.zeros(4, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        entry(torch.zeros(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32))
    for bad in (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.float16),
                [1.0, 2.0]):
        with pytest.raises(TypeError):
            entry(bad, 1.0)
    assert _launches() == before


@pytest.mark.parametrize("entry", [k9.prox, k9.prox_full])
def test_kl_div_entries_raise_without_a_card_and_on_bad_arguments(entry):
    before = _launches()
    f64 = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        entry(f64, f64, 1.0)
    for u, v in ((torch.zeros(4, dtype=torch.int32), f64), (f64, torch.zeros(4, dtype=torch.float16)),
                 ([1.0], f64)):
        with pytest.raises(TypeError):
            entry(u, v, 1.0)
    assert _launches() == before


def test_kernel_arguments_check_shapes_before_the_device(monkeypatch):
    """The argument helpers reject what the kernels do not take: two
    operands of different dtypes or shapes that do not broadcast, lam that
    does not broadcast, a steps array of the wrong shape or type (on the
    CPU the device check comes first, so the device is patched away)."""
    monkeypatch.setattr(_rows, "_element_operands", lambda fname, **operands: None)
    f32, f64 = torch.zeros(3, 4, dtype=torch.float32), torch.zeros(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="differ"):
        _rows.element_args2("k", "lam", f32, f64, 1.0)
    with pytest.raises(ValueError, match="broadcast"):
        _rows.element_args2("k", "lam", f64, torch.zeros(5, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="broadcast"):
        _rows.element_args2("k", "lam", f64, f64, torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="broadcast"):
        _rows.element_args("k", "lam", f64, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="steps"):
        _rows.element_steps_ptr("k", torch.zeros(3, 4, dtype=torch.int32), (3, 4, 2), f64.device)
    with pytest.raises(ValueError, match="steps"):
        _rows.element_steps_ptr("k", torch.zeros(3, 4, 2), (3, 4, 2), f64.device)
    lam = torch.ones(3, 1, dtype=torch.float64)
    (u, v), n, shape, (ptr, rs, cs, value), keep = _rows.element_args2(
        "k", "lam", f64, f64[0], lam)
    # v's one row broadcast along the rows and lam's one value a row are
    # read where they lie (strides (0, 1) and (1, 0)), nothing copied
    assert shape == (3, 4) and n == 4 and u[1:] == (4, 1) and v[1:] == (0, 1)
    assert (ptr, rs, cs) == (lam.data_ptr(), 1, 0)
    assert u[0].data_ptr() == f64.data_ptr() and v[0].data_ptr() == f64.data_ptr()
    (_, _), _, _, (ptr, rs, cs, value), _ = _rows.element_args2("k", "lam", f64, f64, 0.25)
    assert ptr is None and value == 0.25


def _layout(t, rs, cs, n):
    """The elements the kernel reads from t's storage: element i of t's
    shape at ``(i // n) * rs + (i % n) * cs`` from t's data pointer."""
    i = np.arange(t.numel())
    offsets = torch.as_tensor((i // n) * rs + (i % n) * cs)
    span = int(offsets.max()) + 1 if t.numel() else 0
    flat = torch.as_strided(t, (span,), (1,), t.storage_offset())
    return flat[offsets].reshape(t.shape)


@pytest.mark.parametrize("case", ["contiguous", "packed_u", "packed_v", "row_broadcast",
                                  "rows_of_3d", "transposed", "column_broadcast",
                                  "broadcast_between_rows", "scalar"])
def test_row_strided_operands_read_as_their_values(case):
    """K9 reads u, v and lam where they lie when their rows have one row
    stride and a column stride of 1 or 0: the two-argument family's and the
    KL epigraph's views of one packed (rows, 2n) tensor, a row broadcast
    along the rows, one value a row broadcast along it (the epigraph's
    lam), leading dimensions that merge into one; other layouts (a
    transpose, a broadcast between two strided dimensions) are copied.  The
    kernel's index rule, emulated here on the storage, gives each view's
    values."""
    z = torch.arange(5 * 16, dtype=torch.float64).reshape(5, 16)
    t = {"contiguous": z, "packed_u": z[:, :8], "packed_v": z[:, 8:],
         "row_broadcast": torch.broadcast_to(z[0], (5, 16)),
         "rows_of_3d": z.reshape(5, 2, 8)[:, :, :6], "transposed": z.T,
         "column_broadcast": torch.broadcast_to(z[:, :1], (5, 16)),
         "broadcast_between_rows": torch.broadcast_to(z[:2, None, :8], (2, 3, 8)),
         "scalar": torch.tensor(3.0, dtype=torch.float64)}[case]
    n = t.shape[-1] if t.dim() else 1
    got, rs, cs = _rows._row_strided(t, n)
    copied = got.data_ptr() != t.data_ptr()
    assert copied == (case in ("transposed", "broadcast_between_rows"))
    assert torch.equal(_layout(got, rs, cs, n), t)


# -- the registry and the epigraphs reach the dispatch -----------------------

def test_registry_and_kl_epigraph_reach_the_dispatch(monkeypatch):
    """The registry's SUM_KL_DIV, SUM_INV_POS, SUM_EXP and SUM_NEG_ENTR
    proxes call the dispatch, and the SUM_KL_DIV epigraph
    (``newton_epi.epi_sum_kl_div``) calls the KL prox once in each of its
    24 outer steps and once after them: on the card one K9 launch each."""
    from epsilon_tpu_torch.ir import ProxKind
    calls = []
    for name in ("prox_sum_kl_div_reference", "prox_sum_inv_pos_reference",
                 "prox_sum_exp_reference", "prox_sum_neg_entr_reference"):
        real = getattr(ew, name)
        monkeypatch.setattr(ew, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    rng = np.random.RandomState(4)
    u, v = _t(1.0 + rng.rand(2, 6)), _t(0.5 + rng.rand(2, 6))
    reg.KERNELS[ProxKind.SUM_KL_DIV].prox((u, v), _t(np.full((2, 1), 0.3)))
    for kind in (ProxKind.SUM_INV_POS, ProxKind.SUM_EXP, ProxKind.SUM_NEG_ENTR):
        reg.KERNELS[kind].prox(u, 0.7)
    assert calls == ["prox_sum_kl_div_reference", "prox_sum_inv_pos_reference",
                     "prox_sum_exp_reference", "prox_sum_neg_entr_reference"]
    calls.clear()
    ne.epi_sum_kl_div(u, v, _t([0.1, 0.2]))
    assert calls == ["prox_sum_kl_div_reference"] * 25
