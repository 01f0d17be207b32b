"""The plain versions of the per-row loop kernels (K3 ``lse_rows``: the
LOG_SUM_EXP prox and epigraph; K4 ``epi_sum_square``; K5 ``epi_neg_log``)
against the JAX package, and their wrappers' dispatch, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
holds them to these plain versions there); on a CPU tensor each prox
module dispatches to the plain version, which is the port's PyTorch code
of the JAX functions ``prox_log_sum_exp`` (``vector.py``),
``epi_log_sum_exp`` (``newton_epi.py``), ``_epi_sum_square``
(``registry.py``) and ``epi_sum_neg_log`` (``elementwise.py``).  Inputs
are made with numpy from a seed at the library rows' shapes (mnist's 64 x
10 rows cut from 10,000, max_softmax's 100 x 20, oneclass_svm's 200-vector,
max_gaussian's 10-value spectra) with active and inactive rows, negative
bounds, a scalar and a per-row lam, and a stacked leading axis; the JAX
functions take one vector, so they run under ``jax.vmap``.

Tolerances, f64:

- the LOG_SUM_EXP prox and the SUM_SQUARE epigraph: rtol 1e-9, atol
  1e-10 (the same fixed-count iterations; the packages differ in the
  rounding of elementary functions and sums);
- the epigraphs solved by implicit Newton on lambda (LOG_SUM_EXP,
  SUM_NEG_LOG): atol 1e-5 against the JAX package, and the port's own
  optimality residual (x = prox(v, t - s), f(x) = t on active rows) at
  1e-9, as in ``test_torch_prox_kernels.py``: the JAX loop's non-strict
  bracket test can leave lam about 1e-5 off the root after its 24 steps
  (ROADMAP watch list).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import steps_out_of_counts
from epsilon_tpu.ops.prox import elementwise as jew
from epsilon_tpu.ops.prox import registry as jreg
from epsilon_tpu.ops.prox import vector as jvec
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ops.kernels import _rows, epi_neg_log, epi_sum_square, lse_rows
from epsilon_tpu_torch.ops.prox import elementwise as ew
from epsilon_tpu_torch.ops.prox import matrix as mx
from epsilon_tpu_torch.ops.prox import newton_epi as ne
from epsilon_tpu_torch.ops.prox import registry as reg
from epsilon_tpu_torch.ops.prox import vector as vec

RTOL, ATOL = 1e-9, 1e-10
EPI_ATOL = 1e-5
RESIDUAL_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _vmap(fn, batch_dims):
    for _ in range(batch_dims):
        fn = jax.vmap(fn)
    return fn


def _lse(v):
    m = v.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(v - m).sum(axis=-1, keepdims=True)))[..., 0]


def _inputs(kind, shape, seed):
    """``(v, p)`` of the batch ``shape[:-1]``: v from a seed, p the per-row
    lam (log-uniform 1e-3..1e3) or s, placed so that about a third of the
    rows are inactive and some bounds are negative."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(shape) * 2.0
    u = rng.uniform(-1.0, 1.0, shape[:-1])
    if kind == "lse_prox":
        return v, 10.0 ** (3.0 * u)
    if kind == "lse_epi":
        return v, _lse(v) + 3.0 * u - 1.0
    if kind == "sum_square":
        return v, (v * v).sum(axis=-1) * (1.25 * u + 0.25)
    v = np.abs(v) + 0.05
    v[rng.rand(*shape[:-1]) < 0.25, 0] *= -1.0
    return v, -np.log(np.abs(v)).sum(axis=-1) + 3.0 * u - 1.0


ROWS = [(64, 10), (100, 20), (3, 8, 10), (7, 1), (5, 33)]


# -- K3 (a): the LOG_SUM_EXP prox --------------------------------------------

@pytest.mark.parametrize("lam_kind", ["per_row", "scalar", "scalar_tensor"])
@pytest.mark.parametrize("shape", ROWS)
def test_prox_log_sum_exp_matches_jax(shape, lam_kind):
    v, lam = _inputs("lse_prox", shape, seed=len(shape) * 100 + shape[-1])
    if lam_kind != "per_row":
        lam = float(lam.reshape(-1)[0])
    p = _t(lam) if lam_kind != "scalar" else lam
    x = vec.prox_log_sum_exp(_t(v), p)
    assert x.shape == v.shape
    if lam_kind == "per_row":
        want = _vmap(jvec.prox_log_sum_exp, len(shape) - 1)(jnp.asarray(v), jnp.asarray(lam))
    else:
        want = _vmap(lambda r: jvec.prox_log_sum_exp(r, lam), len(shape) - 1)(jnp.asarray(v))
    np.testing.assert_allclose(_np(x), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_prox_log_sum_exp_one_vector_matches_jax():
    v, lam = _inputs("lse_prox", (1, 10), seed=3)
    x = vec.prox_log_sum_exp(_t(v[0]), _t(lam[0]))
    want = jvec.prox_log_sum_exp(jnp.asarray(v[0]), float(lam[0]))
    np.testing.assert_allclose(_np(x), np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the epigraphs -----------------------------------------------------------

def _check_epi(kind, shape, seed, port, jax_fn, prox_ref, feval, atol):
    v, s = _inputs(kind, shape, seed)
    x, t = port(_t(v), _t(s))
    assert x.shape == v.shape and t.shape == s.shape
    wx, wt = _vmap(jax_fn, len(shape) - 1)(jnp.asarray(v), jnp.asarray(s))
    np.testing.assert_allclose(_np(x), np.asarray(wx), rtol=RTOL, atol=atol)
    np.testing.assert_allclose(_np(t), np.asarray(wt), rtol=RTOL, atol=atol)
    inactive = np.all(_np(x) == v, axis=-1)
    if inactive.size >= 8:
        assert inactive.any() and not inactive.all()
    np.testing.assert_array_equal(_np(t)[inactive], s[inactive])
    if prox_ref is not None:
        # the port's own optimality: x = prox(v, t - s) and f(x) = t
        act = ~inactive
        lam = _t((_np(t) - s)[act])
        np.testing.assert_allclose(_np(x)[act], _np(prox_ref(_t(v[act]), lam)),
                                   rtol=0, atol=RESIDUAL_ATOL)
        np.testing.assert_allclose(_np(feval(x[torch.as_tensor(act)])), _np(t)[act],
                                   rtol=0, atol=RESIDUAL_ATOL)
    return v, s, inactive


@pytest.mark.parametrize("shape", ROWS)
def test_epi_log_sum_exp_matches_jax(shape):
    _check_epi("lse_epi", shape, seed=shape[-1], port=ne.epi_log_sum_exp,
               jax_fn=jvec.epi_log_sum_exp,
               prox_ref=lambda v, lam: vec.prox_log_sum_exp_reference(v, lam),
               feval=vec.eval_log_sum_exp, atol=EPI_ATOL)


@pytest.mark.parametrize("shape", [(1, 200), (8, 200), (16, 1), (4, 31), (3, 5, 33)])
def test_epi_sum_square_matches_jax(shape):
    _check_epi("sum_square", shape, seed=shape[-1], port=reg._epi_sum_square,
               jax_fn=jreg._epi_sum_square, prox_ref=None, feval=None, atol=ATOL)


def test_epi_sum_square_one_vector_and_scalar_bound_match_jax():
    """oneclass_svm's call: one 200-vector and a 0-d bound, active, and the
    same vector with a bound that makes it inactive."""
    v, _ = _inputs("sum_square", (1, 200), seed=5)
    for s in (-3.0, 0.5 * float((v * v).sum()), 2.0 * float((v * v).sum())):
        x, t = reg._epi_sum_square(_t(v[0]), _t(s))
        assert t.shape == ()
        wx, wt = jreg._epi_sum_square(jnp.asarray(v[0]), jnp.asarray(s))
        np.testing.assert_allclose(_np(x), np.asarray(wx), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(t), float(wt), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(8, 10), (64, 10), (16, 1), (4, 31), (3, 5, 33)])
def test_epi_sum_neg_log_matches_jax(shape):
    _check_epi("neg_log", shape, seed=shape[-1], port=ew.epi_sum_neg_log,
               jax_fn=jew.epi_sum_neg_log,
               prox_ref=lambda v, lam: torch.clamp(ew.prox_sum_neg_log(v, lam[..., None]),
                                                   min=1e-12),
               feval=ew.eval_sum_neg_log, atol=EPI_ATOL)


def test_epi_neg_log_det_spectrum_matches_jax():
    """max_gaussian's call: the 10 x 10 NEG_LOG_DET epigraph, whose
    spectrum goes through the SUM_NEG_LOG epigraph, active and inactive."""
    from epsilon_tpu.ops.prox import matrix as jmx
    rng = np.random.RandomState(7)
    A = rng.standard_normal((10, 10))
    V = A @ A.T / 10 + 0.1 * np.eye(10)
    f = -np.log(np.linalg.eigvalsh(V)).sum()
    for s in (f - 2.0, f + 1.0, -5.0):
        X, t = mx.epi_neg_log_det(_t(V), _t(s))
        wX, wt = jmx.epi_neg_log_det(jnp.asarray(V), jnp.asarray(s))
        np.testing.assert_allclose(_np(X), np.asarray(wX), rtol=RTOL, atol=EPI_ATOL)
        np.testing.assert_allclose(float(t), float(wt), rtol=RTOL, atol=EPI_ATOL)


# -- dispatch and the kernel entries -------------------------------------------

DISPATCH = [
    ("lse_prox", lambda v, p: vec.prox_log_sum_exp(v, p),
     lambda v, p: vec.prox_log_sum_exp_reference(v, p)),
    ("lse_epi", lambda v, p: ne.epi_log_sum_exp(v, p),
     lambda v, p: ne.epi_log_sum_exp_reference(v, p)),
    ("sum_square", lambda v, p: reg._epi_sum_square(v, p),
     lambda v, p: reg._epi_sum_square_reference(v, p)),
    ("neg_log", lambda v, p: ew.epi_sum_neg_log(v, p),
     lambda v, p: ew.epi_sum_neg_log_reference(v, p)),
]
ENTRIES = [("lse_prox", lse_rows.prox_rows), ("lse_epi", lse_rows.epi_rows),
           ("sum_square", epi_sum_square.epi_rows), ("neg_log", epi_neg_log.epi_rows),
           # the full-count builds of the kernels whose loops exit early
           ("lse_prox", lse_rows.prox_rows_full), ("lse_epi", lse_rows.epi_rows_full),
           ("neg_log", epi_neg_log.epi_rows_full)]


def _counts():
    return (lse_rows.prox_launches, lse_rows.epi_launches, epi_sum_square.launches,
            epi_neg_log.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,dispatch,plain", DISPATCH)
def test_cpu_dispatch_is_the_plain_version_bitwise(kind, dispatch, plain, dtype):
    v, p = _inputs(kind, (6, 9), seed=1)
    v, p = torch.as_tensor(v, dtype=dtype), torch.as_tensor(p, dtype=dtype)
    before = _counts()
    got, want = dispatch(v, p), plain(v, p)
    got, want = [o if isinstance(o, tuple) else (o,) for o in (got, want)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _counts() == before


@pytest.mark.parametrize("kind,entry", ENTRIES)
def test_kernel_entry_raises_without_a_card(kind, entry):
    v, p = _inputs(kind, (4, 5), seed=2)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        entry(_t(v), _t(p))
    assert _counts() == before


@pytest.mark.parametrize("kind,dispatch,plain", DISPATCH)
def test_dispatch_raises_on_another_device(kind, dispatch, plain):
    with pytest.raises(ValueError, match="CUDA"):
        dispatch(torch.zeros(4, 5, device="meta"), torch.zeros(4, device="meta"))


@pytest.mark.parametrize("kind,entry", ENTRIES)
def test_kernel_entry_rejects_bad_dtype_and_shape(kind, entry):
    with pytest.raises(TypeError):
        entry(torch.zeros(4, 5, dtype=torch.int32), 1.0)
    with pytest.raises(TypeError):
        entry(torch.zeros(4, 5, dtype=torch.float16), 1.0)
    with pytest.raises(ValueError):
        entry(torch.zeros(4, 0), 1.0)
    with pytest.raises(ValueError):
        entry(torch.zeros(()), 1.0)
    with pytest.raises(TypeError):
        entry([1.0, 2.0], 1.0)


def test_row_scalar_forms():
    v = torch.zeros(3, 4, 5, dtype=torch.float64)
    batch = (3, 4)
    # a host number and a one-element CPU tensor go by value
    assert _rows.row_scalar("f", "s", 2.5, v, batch)[:3] == (None, 0, 2.5)
    assert _rows.row_scalar("f", "s", torch.tensor([1.5]), v, batch)[:3] == (None, 0, 1.5)
    assert _rows.row_scalar("f", "s", np.float32(0.5), v, batch)[:3] == (None, 0, 0.5)
    # a per-row tensor is broadcast to the rows, contiguous, stride 1
    ptr, stride, _, keep, shape = _rows.row_scalar("f", "s", torch.arange(4.0), v, batch)
    assert stride == 1 and shape == (4,) and keep.shape == batch and keep.is_contiguous()
    assert keep.dtype == v.dtype and ptr == keep.data_ptr()
    with pytest.raises(ValueError, match="broadcast"):
        _rows.row_scalar("f", "s", torch.zeros(5), v, batch)
    with pytest.raises(ValueError):
        _rows.row_scalar("f", "s", torch.zeros(3, 4, device="meta"), v, batch)


def test_steps_array_is_checked():
    v = torch.zeros(3, 4, 5, dtype=torch.float64)
    assert _rows.steps_ptr("f", None, v) is None
    steps = torch.zeros(3, 4, len(_rows.STEP_COUNTS), dtype=torch.int32)
    assert _rows.steps_ptr("f", steps, v) == steps.data_ptr()
    for bad in (torch.zeros(3, 4, 4), torch.zeros(12, 4, dtype=torch.int32),
                torch.zeros(3, 4, 3, dtype=torch.int32), torch.zeros(3, 4, 4, dtype=torch.int64),
                torch.zeros(4, 3, 4, dtype=torch.int32).transpose(0, 1),
                torch.zeros(3, 4, 4, dtype=torch.int32, device="meta"), [0] * 48):
        with pytest.raises(ValueError, match="steps"):
            _rows.steps_ptr("f", bad, v)


def _full_counts(kernel, n, active):
    """What a full-count build records for rows of width n."""
    per_lane = -(-n // 32)
    row = {"lse_prox_rows": [0, 25, 27 * 30 * per_lane, 28 * 30 * n],
           "lse_epi_rows": [24, 25 * 25, 25 * 27 * 30 * per_lane, 25 * 28 * 30 * n],
           "epi_neg_log_rows": [24, 0, 0, 0]}[kernel]
    return np.array([row if a else [0, 0, 0, 0] for a in active])


@pytest.mark.parametrize("n", [10, 33])
@pytest.mark.parametrize("kernel", ["lse_prox_rows", "lse_epi_rows", "epi_neg_log_rows"])
def test_steps_out_of_counts(kernel, n):
    active = [True, True, kernel == "lse_prox_rows"]
    full = _full_counts(kernel, n, active)
    assert not steps_out_of_counts(kernel, full, full, n).any()
    taken = {"lse_prox_rows": [0, 9, 40, 40 * n], "lse_epi_rows": [5, 60, 400, 400 * n],
             "epi_neg_log_rows": [11, 0, 0, 0]}[kernel]
    steps = np.array([taken if a else [0, 0, 0, 0] for a in active])
    assert not steps_out_of_counts(kernel, steps, full, n).any()
    for row, col, value in [(0, 0, 25), (0, 1, 0), (1, 2, 10 ** 6), (1, 3, 0)]:
        bad = steps.copy()
        bad[row, col] = value
        if kernel == "epi_neg_log_rows" and col > 0:
            bad[row, col] = 1              # K5 has no nu or Lambert loop
        if (bad == steps).all():
            continue
        assert steps_out_of_counts(kernel, bad, full, n)[row]
    wrong_full = full.copy()
    wrong_full[0, 0] += 1                  # the full-count build must run its count
    assert steps_out_of_counts(kernel, steps, wrong_full, n)[0]


def test_out_shape():
    assert _rows.out_shape("f", "s", (), (1,)) == (1,)
    assert _rows.out_shape("f", "s", (3,), ()) == (3,)
    assert _rows.out_shape("f", "s", (3, 4), (4,)) == (3, 4)
    with pytest.raises(ValueError, match="add rows"):
        _rows.out_shape("f", "s", (3,), (2, 3))
    with pytest.raises(ValueError, match="broadcast"):
        _rows.out_shape("f", "s", (3,), (4,))
