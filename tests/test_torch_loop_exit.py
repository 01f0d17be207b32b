"""The premise of the per-row loop kernels' early exit, held on the port's
own plain loops on the CPU.

The kernels K3 (``csrc/lse_rows.cu``) and K5 (``csrc/epi_neg_log.cu``) stop
a fixed-count loop once its state repeats: each loop is a fixed map of its
state (the Lambert solve ``util.solve_w_log_w``: w; the implicit Newton on
the epigraph's lam, ``newton_epi.implicit_newton_epigraph``: (lam, lo,
hi), since h depends on lam alone), so once the state after step k equals
the state after step k - p the sequence is periodic, and the state after
all N steps is the state after step k - p + ((N - k) mod p).  The kernels
keep the last four states (p <= 4).

Here each loop runs one step at a time, with the plain version's own
operations (each step function is anchored bitwise to the plain routine
it copies), on a seeded grid and on hypothesis cases, in f32 and f64:
the state predicted at the first repeat equals the full-count state
bitwise.  The same holds for ``util.newton_safeguarded``'s loop on the
LOG_SUM_EXP prox's nu (state (x, lo, hi, glo, ghi)), whose state repeats
on some rows once x settles at the root, so K3 exits there too.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_loop_exit.py -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from epsilon_tpu_torch.ops.prox import elementwise as ew
from epsilon_tpu_torch.ops.prox import newton_epi as ne
from epsilon_tpu_torch.ops.prox import util
from epsilon_tpu_torch.ops.prox import vector as vec

# States the kernels keep: a repeat of period up to 4 is found.
PERIODS = 4
DTYPES = [torch.float32, torch.float64]
LAMBERT_STEPS, LAM_STEPS, NU_STEPS = 30, 24, 25


@pytest.fixture(autouse=True)
def _one_thread():
    # many small eager operations: intra-op threads only add overhead
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _run(step, state, iters):
    """Every state s_0 .. s_iters of ``state = step(state)`` (a tuple of
    tensors of the batch shape), and their bit patterns: for each state one
    integer tensor of shape (components,) + batch."""
    states = [state]
    for _ in range(iters):
        state = step(state)
        states.append(state)
    return states, [torch.stack([_bits(a) for a in s]) for s in states]


def _first_repeat(bits):
    """``(k, p)`` per batch element: the first step k whose state equals,
    bitwise, the state p <= PERIODS steps before (the least such p);
    k = p = 0 where no state repeats."""
    shape = bits[0].shape[1:]
    k_rep = torch.zeros(shape, dtype=torch.long)
    p_rep = torch.zeros(shape, dtype=torch.long)
    for k in range(1, len(bits)):
        for p in range(1, min(PERIODS, k) + 1):
            hit = (k_rep == 0) & (bits[k] == bits[k - p]).all(dim=0)
            k_rep[hit], p_rep[hit] = k, p
    return k_rep, p_rep


def _exit_is_exact(bits):
    """The state the kernels return at the first repeat equals the state
    after the full count, on every element that repeats; returns the share
    that repeats, the mean step of the exit and the periods seen."""
    n = len(bits) - 1
    k, p = _first_repeat(bits)
    rep = k > 0
    j = k - p + torch.remainder(n - k, p.clamp(min=1))
    stacked = torch.stack(bits)                       # (n + 1, components, batch)
    index = j.clamp(min=0).expand(stacked.shape[1:])[None]
    predicted = stacked.gather(0, index)[0]
    assert torch.equal(predicted[:, rep], stacked[n][:, rep])
    return (rep.double().mean().item(), k[rep].double().mean().item() if rep.any() else 0.0,
            set(p[rep].tolist()))


# -- util.solve_w_log_w: state w ---------------------------------------------

def _w_start(c):
    tiny = torch.finfo(c.dtype).tiny
    w = torch.where(c > 1.0, c - torch.log(torch.clamp(c, min=1.1)),
                    torch.exp(torch.clamp(c, max=1.0)))
    return torch.clamp(w, min=tiny)


def _w_step(c):
    tiny = torch.finfo(c.dtype).tiny
    return lambda s: (torch.clamp(s[0] - (s[0] + torch.log(s[0]) - c) * s[0] / (s[0] + 1.0),
                                  min=tiny),)


def _lambert(c):
    states, bits = _run(_w_step(c), (_w_start(c),), LAMBERT_STEPS)
    # the step is util.solve_w_log_w's, bitwise
    assert torch.equal(_bits(states[-1][0]), _bits(util.solve_w_log_w(c)))
    return bits


def _c_grid(dtype):
    """Lambert arguments: a seeded spread over [-30, 30] and a dense band
    over [-2.1, -0.5], where the iterate can settle into a 3-cycle."""
    rng = np.random.RandomState(0)
    c = np.concatenate([rng.uniform(-30.0, 30.0, 4000), np.linspace(-2.1, -0.5, 4001),
                        [-np.inf, np.inf, np.nan, 0.0, -0.0, 1.0, 1.1]])
    return torch.as_tensor(c, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lambert_exit_is_exact_on_a_grid(dtype):
    c = _c_grid(dtype)
    share, mean_k, _ = _exit_is_exact(_lambert(c))
    # the premise: nearly every input settles, in a few steps
    assert share > 0.99 and mean_k < 6.0
    band = (c >= -2.1) & (c <= -0.5)
    k, p = _first_repeat(_lambert(c[band]))
    assert 3 in set(p[k > 0].tolist())       # a period-2 test alone would miss these


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-40.0, 40.0, allow_nan=False), min_size=1, max_size=64),
       st.sampled_from(DTYPES))
def test_lambert_exit_is_exact_hypothesis(cs, dtype):
    _exit_is_exact(_lambert(torch.tensor(cs, dtype=dtype)))


# -- newton_epi.implicit_newton_epigraph: state (lam, lo, hi) ----------------

def _kind(kind, dtype):
    """The epigraph parts ``make_epigraph`` gets from the plain version of
    kind (``ew.epi_sum_neg_log_reference``,
    ``ne.epi_log_sum_exp_reference``)."""
    if kind == "neg_log":
        floor = 1e-12 if dtype == torch.float64 else 1e-6
        return dict(feval=ew.eval_sum_neg_log, fgrad=lambda x: -1.0 / x,
                    prox=ew.prox_sum_neg_log, proj=lambda x: torch.clamp(x, min=floor),
                    metric_solve=ne._diag_metric(lambda x: 1.0 / (x * x)))
    return dict(feval=vec.eval_log_sum_exp, fgrad=lambda x: torch.softmax(x, dim=-1),
                prox=lambda vv, lam: vec.prox_log_sum_exp_reference(vv, lam[..., 0]),
                proj=lambda x: x, metric_solve=ne.lse_metric_solve)


def _lam_step(parts, v, s):
    """One step of ``implicit_newton_epigraph``'s loop on (lam, lo, hi)."""
    feval, fgrad, prox = parts["feval"], parts["fgrad"], parts["prox"]
    proj, metric_solve = parts["proj"], parts["metric_solve"]
    big = torch.finfo(v.dtype).max / 4

    def step(state):
        lam, lo, hi = state
        x = proj(prox(v, lam[..., None]))
        h = feval(x) - s - lam
        g = fgrad(x)
        hp = -ne._dot(g, metric_solve(x, lam, g)) - 1.0
        lo = torch.where(h > 0, torch.maximum(lo, lam), lo)
        hi = torch.where(h <= 0, torch.minimum(hi, lam), hi)
        lam_n = lam - h / hp
        fallback = torch.where(hi >= big, torch.clamp(4.0 * lam, min=1.0), 0.5 * (lo + hi))
        bad = (lam_n < lo) | (lam_n > hi) | ~torch.isfinite(lam_n)
        return torch.where(bad, fallback, lam_n), lo, hi
    return step


def _lam_loop(kind, v, s, iters=LAM_STEPS):
    """The bit patterns of every state, and the projection ``(x, t)`` that
    ``implicit_newton_epigraph`` returns after the full count."""
    parts = _kind(kind, v.dtype)
    floor = ne._domain_eps(v.dtype)
    start = (torch.ones_like(s), torch.full_like(s, floor),
             torch.full_like(s, torch.finfo(v.dtype).max / 4 * 2))
    states, bits = _run(_lam_step(parts, v, s), start, iters)
    # the step is implicit_newton_epigraph's, bitwise: its result after k
    # steps is the projection at the k-th lam
    for k in (1, iters):
        x, t = ne.implicit_newton_epigraph(v, s, parts["feval"], parts["fgrad"], parts["prox"],
                                           proj=parts["proj"],
                                           metric_solve=parts["metric_solve"], iters=k)
        lam = states[k][0]
        xk = parts["proj"](parts["prox"](v, lam[..., None]))
        assert torch.equal(_bits(x), _bits(xk))
        assert torch.equal(_bits(t), _bits(s + torch.maximum(parts["feval"](xk) - s, lam)))
    return bits, (x, t)


def _epi_inputs(kind, rows, n, dtype, seed):
    """Active rows (the point lies outside the epigraph) from a seed, as
    the kernels' tests make them; K5's rows are positive."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal((rows, n)) * 2.0
    u = rng.uniform(-1.0, 1.0, rows)
    if kind == "neg_log":
        v = np.abs(v) + 0.05
        s = -np.log(v).sum(axis=1) - 0.5 - 2.0 * (u + 1.0)
    else:
        m = v.max(axis=1)
        s = m + np.log(np.exp(v - m[:, None]).sum(axis=1)) - 0.5 - 2.0 * (u + 1.0)
    return torch.as_tensor(v, dtype=dtype), torch.as_tensor(s, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,rows,n", [("neg_log", 400, 10), ("neg_log", 64, 33),
                                         ("lse", 24, 20), ("lse", 8, 33)])
def test_lam_exit_is_exact(kind, rows, n, dtype):
    v, s = _epi_inputs(kind, rows, n, dtype, seed=rows + n)
    bits, full = _lam_loop(kind, v, s)
    share, mean_k, _ = _exit_is_exact(bits)
    assert share > 0.5 and mean_k < LAM_STEPS
    # the full count is the plain version's loop: every row here is active
    plain = ew.epi_sum_neg_log_reference if kind == "neg_log" else ne.epi_log_sum_exp_reference
    for a, b in zip(plain(v, s), full):
        assert torch.equal(_bits(a), _bits(b))


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 40), st.sampled_from(DTYPES))
def test_neg_log_lam_exit_is_exact_hypothesis(seed, n, dtype):
    v, s = _epi_inputs("neg_log", 16, n, dtype, seed)
    _exit_is_exact(_lam_loop("neg_log", v, s)[0])


# -- util.newton_safeguarded: state (x, lo, hi, glo, ghi) ---------------------

def _nu_step(g_and_gp):
    """One step of ``util.newton_safeguarded``."""
    def step(state):
        x, lo, hi, glo, ghi = state
        gx, gp = g_and_gp(x)
        neg = gx < 0
        lo = torch.where(neg, torch.maximum(lo, x), lo)
        glo = torch.where(neg, gx, glo)
        ghi = torch.where(neg, 0.5 * ghi, ghi)
        hi = torch.where(neg, hi, torch.minimum(hi, x))
        ghi = torch.where(neg, ghi, gx)
        glo = torch.where(neg, glo, 0.5 * glo)
        gp_nz = gp != 0
        step_ = torch.where(gp_nz, gx / torch.where(gp_nz, gp, torch.ones_like(gp)),
                            torch.zeros_like(gx))
        xn = x - step_
        denom = ghi - glo
        d_nz = denom != 0
        mid = 0.5 * (lo + hi)
        falsi = torch.where(d_nz, (lo * ghi - hi * glo)
                            / torch.where(d_nz, denom, torch.ones_like(denom)), mid)
        falsi = torch.where(torch.isfinite(falsi), torch.minimum(torch.maximum(falsi, lo), hi),
                            mid)
        bad = (xn <= lo) | (xn >= hi) | ~torch.isfinite(xn)
        return torch.where(bad, falsi, xn), lo, hi, glo, ghi
    return step


@pytest.mark.parametrize("dtype", DTYPES)
def test_safeguarded_newton_exit_is_exact(dtype):
    """The LOG_SUM_EXP prox's loop on nu (``vec.prox_log_sum_exp_reference``)
    over rows whose Lambert arguments fall in the 3-cycle band and over
    seeded rows.  Its state is not a bracket that only shrinks: once x
    settles between two neighbouring floats at the root, glo and ghi trade
    places and the Illinois halving undoes itself, so the state repeats on
    some rows within the 25 steps, and the exit is exact there too."""
    rng = np.random.RandomState(3)
    q = rng.uniform(0.11, 0.40, (64, 10))              # W(e^c) for c in [-2.1, -0.5]
    lam_band = q.sum(axis=1)
    v_band = q + np.log(q) + 1.0 - np.log(lam_band)[:, None]
    v_seed = rng.standard_normal((64, 10)) * 2.0
    lam_seed = 10.0 ** rng.uniform(-3.0, 3.0, 64)
    v = torch.as_tensor(np.concatenate([v_band, v_seed]), dtype=dtype)
    lam = torch.as_tensor(np.concatenate([lam_band, lam_seed]), dtype=dtype)
    n = v.shape[-1]
    c0 = v + torch.log(lam)[..., None] - 1.0
    lse_c0 = torch.logsumexp(c0, dim=-1)
    lo = torch.amin(c0, dim=-1) - lam / n - torch.log(lam / n)
    hi = lse_c0 - torch.log(lam) + 1.0

    def g(nu):
        return lam - torch.sum(util.solve_w_log_w(c0 - nu[..., None]), dim=-1)

    def g_and_gp(nu):
        w = util.solve_w_log_w(c0 - nu[..., None])
        return lam - torch.sum(w, dim=-1), torch.sum(w / (1.0 + w), dim=-1)

    nu0 = torch.minimum(torch.maximum(lse_c0 - torch.log(lam), lo), hi)
    states, bits = _run(_nu_step(g_and_gp), (nu0, lo, hi, g(lo), g(hi)), NU_STEPS)
    for k in (1, NU_STEPS):
        # the step is util.newton_safeguarded's, bitwise
        want = util.newton_safeguarded(g, None, nu0, lo, hi, iters=k, g_and_gprime=g_and_gp)
        assert torch.equal(_bits(states[k][0]), _bits(want))
    share, mean_k, periods = _exit_is_exact(bits)
    assert share > 0.1 and periods <= {2, 3, 4}
    # the prox at the full count's nu is the plain version's
    x = v - util.solve_w_log_w(c0 - states[-1][0][..., None])
    assert torch.equal(_bits(x), _bits(vec.prox_log_sum_exp_reference(v, lam)))
