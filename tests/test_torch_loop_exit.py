"""The premise of the per-row loop kernels' early exit, held on the port's
own plain loops on the CPU.

The kernels K3 (``csrc/lse_rows.cu``), K4 (``csrc/epi_sum_square.cu``) and
K5 (``csrc/epi_neg_log.cu``) stop a fixed-count loop once its state repeats: each loop is a fixed map of its
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
LOG_SUM_EXP prox's nu and on the SUM_SQUARE epigraph's cubic (state (x,
lo, hi, glo, ghi)), whose state repeats on some rows once x settles at the
root, so K3 and K4 exit there too; K4's widening of its bracket (state hi)
repeats at its first step.

K6 (``csrc/sum_logistic.cu``) runs ``newton_safeguarded``'s loop for
each element of the SUM_LOGISTIC prox alone (one thread an element), and
exits at its state's first repeat the same way; its premise is held here
on v in +-60 with lam over 1e-6..1e6 and on special values.

K9 (``csrc/sum_kl_div.cu``) and K10 (``csrc/sum_inv_pos.cu``) widen the
bracket's upper end (state hi: it stops at its first step that leaves hi
unchanged, period 1) and then run the safeguarded Newton one thread an
element to its count (K6's exit, whose premise still holds on their loops
here, cost them more than it saved); K11 (``csrc/w_log_w.cu``) runs the
Lambert solve on the SUM_EXP and SUM_NEG_ENTR proxes' arguments with K3's
exit.  Their premises are held here on wide ranges and special values.

K3's prox runs rows of up to 16 two to a warp, its sums through 16-wide
butterflies in place of 32-wide ones; a plain simulation of both holds
them to the same bits here.

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


def _cycled_exit_is_exact(bits):
    """The rule of the two-rows-a-warp loop (row_loops.cuh iterate() at
    W = 16): a row whose state repeated at step k with period p steps on
    through its cycle until its warp stops at a later step K, and returns
    the state of step K if (N - K) mod p is 0, else of step
    K - p + ((N - K) mod p); that is the full count's state, for every K."""
    n = len(bits) - 1
    k, p = _first_repeat(bits)
    stacked = torch.stack(bits)
    for stop in range(1, n + 1):
        rep = (k > 0) & (k <= stop)
        r = torch.remainder(n - stop, p.clamp(min=1))
        j = torch.where(r == 0, torch.full_like(k, stop), stop - p + r).clamp(min=0)
        predicted = stacked.gather(0, j.expand(stacked.shape[1:])[None])[0]
        assert torch.equal(predicted[:, rep], stacked[n][:, rep])


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


# -- elementwise.prox_sum_logistic_reference (K6): one Newton an element ---

LOGISTIC_STEPS = 40


def _logistic_start(v, lam):
    """The SUM_LOGISTIC prox's Newton step and its start (``x + lam
    sigmoid(x) = v`` an element)."""
    lam = torch.broadcast_to(lam, v.shape)

    def g(x):
        return x + lam * torch.sigmoid(x) - v

    def g_and_gp(x):
        sig = torch.sigmoid(x)
        return g(x), 1.0 + lam * sig * (1.0 - sig)

    x0 = v - lam * torch.sigmoid(v)
    lo, hi = v - lam - 1e-9, v + 1e-9
    return _nu_step(g_and_gp), (x0, lo, hi, g(lo), g(hi))


def _logistic_loop(v, lam):
    """Every state of the SUM_LOGISTIC prox's 40 safeguarded Newton steps,
    anchored bitwise to the plain version; returns their bits."""
    states, bits = _run(*_logistic_start(v, lam), LOGISTIC_STEPS)
    # the step is the plain version's, bitwise
    assert torch.equal(_bits(states[-1][0]), _bits(ew.prox_sum_logistic_reference(v, lam)))
    return bits


@pytest.mark.parametrize("dtype", DTYPES)
def test_sum_logistic_newton_exit_is_exact(dtype):
    """K6's loop (one thread an element) on v in +-60 with lam over
    1e-6..1e6, one an element and one decade a row: the state repeats
    within the 40 steps on most elements (x settles between two
    neighbouring floats and the Illinois halving undoes itself) or runs to
    the count, and at a repeat the exit's state is the full count's
    bitwise.  Special values (NaN, +-inf, 0, -0, lam <= 0) too.  In f32
    about half the elements repeat; in f64 few do (6 % here: the iterate
    rarely settles within 40 steps), and the rest run the count."""
    rng = np.random.RandomState(12)
    v = np.concatenate([rng.uniform(-60.0, 60.0, 3000), rng.uniform(-60.0, 60.0, 13 * 200)])
    lam = np.concatenate([10.0 ** rng.uniform(-6.0, 6.0, 3000),
                          np.repeat(10.0 ** np.arange(-6.0, 7.0), 200)])
    vs = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -7.5]
    lams = [np.nan, np.inf, 0.0, -0.0, -1.0, 1e-30, 1.0, 1e30]
    sv, sl = (a.ravel() for a in np.meshgrid(np.array(vs), np.array(lams), indexing="ij"))
    v, lam = (torch.as_tensor(np.concatenate(a), dtype=dtype) for a in ((v, sv), (lam, sl)))
    share, _, periods = _exit_is_exact(_logistic_loop(v, lam))
    assert share > (0.3 if dtype == torch.float32 else 0.03) and periods <= {1, 2, 3, 4}


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.floats(-80.0, 80.0, allow_nan=False),
                          st.floats(-6.0, 6.0, allow_nan=False)), min_size=1, max_size=64),
       st.sampled_from(DTYPES))
def test_sum_logistic_newton_exit_is_exact_hypothesis(pairs, dtype):
    v = torch.tensor([a for a, _ in pairs], dtype=dtype)
    lam = torch.tensor([10.0 ** b for _, b in pairs], dtype=dtype)
    _exit_is_exact(_logistic_loop(v, lam))


# -- K6 and K8: the exit checked every fourth step (row_loops.cuh iterate4) --

def _kernel_slot(iters, k, p):
    """iterate4()'s rule: at the check after step k, a repeat of period p
    returns the slot 4 + ((iters - k) mod p) - p of s0 .. s4 (steps k - 4
    .. k)."""
    return 4 + (iters - k) % p - p


def _iterate4(step, state, iters, slot=_kernel_slot, tail=None):
    """iterate4() emulated on a batch, one element a lane: four steps at a
    time, the newest state compared with the four before it (x first, then
    the whole state), an element leaving at its first repeat with the
    state of ``slot``; the rest of the count (``tail``, iters mod 4 steps)
    after the last whole four.  Returns the states reached and the steps
    each element ran."""
    tail = iters % 4 if tail is None else tail
    out = [a.clone() for a in state]
    shape = state[0].shape
    done = torch.zeros(shape, dtype=torch.bool)
    ran = torch.full(shape, iters, dtype=torch.long)
    k = 0
    while k + 4 <= iters:
        slots = [state]
        for _ in range(4):
            slots.append(step(slots[-1]))
        k += 4
        bits = [torch.stack([_bits(a) for a in sl]) for sl in slots]
        x_hit = torch.zeros(shape, dtype=torch.bool)
        for j in range(4):
            x_hit |= bits[4][0] == bits[j][0]
        p = torch.zeros(shape, dtype=torch.long)
        for j, period in ((3, 1), (2, 2), (1, 3), (0, 4)):
            hit = x_hit & (p == 0) & (bits[4] == bits[j]).all(dim=0)
            p[hit] = period
        new = ~done & (p > 0)
        for period in range(1, 5):
            at = new & (p == period)
            if at.any():
                chosen = slots[slot(iters, k, period)]
                for a, c in zip(out, chosen):
                    a[at] = c[at]
                ran[at] = k
        done |= new
        state = slots[4]
    for _ in range(tail):
        state = step(state)
    for a, c in zip(out, state):
        a[~done] = c[~done]
    return out, ran


def _every4_is_exact(step, state, iters):
    """The emulated exit's states equal the full count's bitwise; returns
    the share of elements that left early and the steps they ran."""
    full = state
    for _ in range(iters):
        full = step(full)
    got, ran = _iterate4(step, state, iters)
    for a, b in zip(got, full):
        assert torch.equal(_bits(a), _bits(b))
    early = ran < iters
    assert bool((ran[early] % 4 == 0).all())
    return early.double().mean().item(), ran


def _logistic_cases(dtype):
    """test_sum_logistic_newton_exit_is_exact's inputs."""
    rng = np.random.RandomState(12)
    v = np.concatenate([rng.uniform(-60.0, 60.0, 3000), rng.uniform(-60.0, 60.0, 13 * 200)])
    lam = np.concatenate([10.0 ** rng.uniform(-6.0, 6.0, 3000),
                          np.repeat(10.0 ** np.arange(-6.0, 7.0), 200)])
    vs = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -7.5]
    lams = [np.nan, np.inf, 0.0, -0.0, -1.0, 1e-30, 1.0, 1e30]
    sv, sl = (a.ravel() for a in np.meshgrid(np.array(vs), np.array(lams), indexing="ij"))
    return (torch.as_tensor(np.concatenate(a), dtype=dtype) for a in ((v, sv), (lam, sl)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sum_logistic_every_fourth_step_exit_is_exact(dtype):
    """K6's exit as iterate4() runs it (a check after every fourth step,
    the full count's state from the slot of the cycle step 40 reaches) on
    the inputs of ``test_sum_logistic_newton_exit_is_exact``: the full
    count's state bitwise, and most f32 elements leave early."""
    v, lam = _logistic_cases(dtype)
    _logistic_loop(v, lam)                        # anchors the step to the plain version
    share, _ = _every4_is_exact(*_logistic_start(v, lam), LOGISTIC_STEPS)
    assert share > (0.3 if dtype == torch.float32 else 0.03)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.floats(-80.0, 80.0, allow_nan=False),
                          st.floats(-6.0, 6.0, allow_nan=False)), min_size=1, max_size=64),
       st.sampled_from(DTYPES))
def test_sum_logistic_every_fourth_step_exit_is_exact_hypothesis(pairs, dtype):
    v = torch.tensor([a for a, _ in pairs], dtype=dtype)
    lam = torch.tensor([10.0 ** b for _, b in pairs], dtype=dtype)
    _every4_is_exact(*_logistic_start(v, lam), LOGISTIC_STEPS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_fourth_step_rule_catches_a_wrong_slot_or_tail(dtype):
    """The emulation is the kernels' rule: a slot one off (the state a step
    later in the cycle) or a tail one step short gives another state than
    the full count's on these inputs, so the tests above would fail."""
    v, lam = _logistic_cases(dtype)
    step, state = _logistic_start(v, lam)
    full = state
    for _ in range(LOGISTIC_STEPS):
        full = step(full)
    got, _ = _iterate4(step, state, LOGISTIC_STEPS,
                       slot=lambda iters, k, p: 4 + (iters - k + 1) % p - p)
    assert not torch.equal(_bits(got[0]), _bits(full[0]))
    # K8's Newton runs 25 steps: 6 whole fours and a tail of one
    step, state = _epi_exp_loops(*_epi_exp_inputs(dtype))[1]
    full = state
    for _ in range(EPI_EXP_NEWTON):
        full = step(full)
    got, _ = _iterate4(step, state, EPI_EXP_NEWTON)
    assert torch.equal(_bits(got[0]), _bits(full[0]))
    got, _ = _iterate4(step, state, EPI_EXP_NEWTON, tail=0)
    assert not torch.equal(_bits(got[0]), _bits(full[0]))


# -- elementwise.epi_exp_reference (K8): widening (lo), then Newton -------------

EPI_EXP_WIDEN, EPI_EXP_NEWTON = 40, 25


def _epi_exp_inputs(dtype):
    """v and s over +-10 (inactive, active and s <= 0 elements), over +-60
    with s up to e^60 (where 25 steps leave some elements short of the
    root), and every pair of NaN, +-inf, 0, -0, +-1e30, 1, -1 and 50."""
    rng = np.random.RandomState(14)
    v = [rng.uniform(-10.0, 10.0, 2000),
         rng.uniform(30.0, 60.0, 1000) * rng.choice([-1.0, 1.0], 1000)]
    s = [rng.uniform(-10.0, 10.0, 2000),
         np.exp(rng.uniform(0.0, 60.0, 1000)) * rng.choice([-1.0, 1.0, 1.0], 1000)]
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0])
    sv, ss = (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))
    return (torch.as_tensor(np.concatenate(a + [b]), dtype=dtype) for a, b in ((v, sv), (s, ss)))


def _epi_exp_loops(v, s):
    """The widening's step and start, the Newton's step and start (after
    the full widening and the bracket's clamp), with the plain version's
    operations; the result after both full counts is
    ``epi_exp_reference``'s, bitwise."""
    def g(x):
        ex = torch.exp(x)
        return x + ex * ex - s * ex - v

    def g_and_gp(x):
        ex = torch.exp(x)
        return g(x), 1.0 + 2.0 * ex * ex - s * ex

    def widen(state):
        lo = state[0]
        return (torch.where(g(lo) > 0, lo - 2.0 * torch.abs(lo) - 2.0, lo),)

    lo0 = (torch.clamp(v, max=0.0) - 1.0,)
    lo = lo0
    for _ in range(EPI_EXP_WIDEN):
        lo = widen(lo)
    lo = lo[0]
    tiny = torch.finfo(v.dtype).tiny
    lo = torch.where(s > 0, torch.maximum(lo, torch.log(torch.clamp(s, min=tiny) * 0.5)), lo)
    newton = (_nu_step(g_and_gp), (0.5 * (lo + v), lo, v, g(lo), g(v)))
    state = newton[1]
    for _ in range(EPI_EXP_NEWTON):
        state = newton[0](state)
    inactive = torch.exp(v) <= s
    out = (torch.where(inactive, v, state[0]), torch.where(inactive, s, torch.exp(state[0])))
    for a, b in zip(out, ew.epi_exp_reference(v, s)):
        assert torch.equal(_bits(a), _bits(b))
    return (widen, lo0), newton


@pytest.mark.parametrize("dtype", DTYPES)
def test_epi_exp_widening_stays_once_lo_stops(dtype):
    """The widening's state is lo alone: once a step leaves lo's bits as
    they were, every later step does (K8 leaves the loop there, period 1),
    on NaN, +-inf and s <= 0 too; every element stops within the 40 steps
    on these inputs."""
    v, s = _epi_exp_inputs(dtype)
    (widen, lo0), _ = _epi_exp_loops(v, s)
    states, bits = _run(widen, lo0, EPI_EXP_WIDEN)
    k, p = _first_repeat(bits)
    assert bool((k > 0).all()) and bool((p == 1).all())
    for j in range(1, EPI_EXP_WIDEN + 1):
        stopped = k <= j
        assert torch.equal(bits[j][:, stopped], bits[EPI_EXP_WIDEN][:, stopped])


@pytest.mark.parametrize("dtype", DTYPES)
def test_epi_exp_newton_every_fourth_step_exit_is_exact(dtype):
    """K8's Newton (25 steps: six checks after every fourth step, then the
    last step alone) as iterate4() runs it: the full count's state
    bitwise on every element; about a quarter of the f32 elements and a
    sixth of the f64 ones leave early on these inputs."""
    v, s = _epi_exp_inputs(dtype)
    _, (step, state) = _epi_exp_loops(v, s)
    share, _ = _every4_is_exact(step, state, EPI_EXP_NEWTON)
    assert share > (0.2 if dtype == torch.float32 else 0.1)


# -- registry._epi_sum_square_reference (K4): widening (hi), then Newton -----

WIDEN_STEPS = 40


def _sum_square_rows(rows, n, dtype, seed):
    """Rows as the kernels' tests make them (a third inactive, some bounds
    negative), then rows holding NaN, +inf and -inf and rows whose bound is
    NaN, +inf, -inf, 0 or -0."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal((rows, n)) * 2.0
    s = (v * v).sum(axis=1) * (1.25 * rng.uniform(-1.0, 1.0, rows) + 0.25)
    for r, value in enumerate((np.nan, np.inf, -np.inf)):
        v[r, r % n] = value
    for r, value in enumerate((np.nan, np.inf, -np.inf, 0.0, -0.0)):
        s[3 + r] = value
    return torch.as_tensor(v, dtype=dtype), torch.as_tensor(s, dtype=dtype)


def _sum_square_loops(v, s):
    """The widening's and the Newton's states, step by step, with the plain
    version's operations; the result after the full counts is
    ``_epi_sum_square_reference``'s, bitwise."""
    from epsilon_tpu_torch.ops.prox import registry
    u2 = torch.sum(v * v, dim=-1)

    def g(lam):
        return (s + lam) * (1.0 + 2.0 * lam) ** 2 - u2

    def g_and_gp(lam):
        return g(lam), (1.0 + 2.0 * lam) * (1.0 + 6.0 * lam + 4.0 * s)

    lo = torch.clamp(-s, min=0.0)
    widen, widen_bits = _run(lambda st: (torch.where(g(st[0]) < 0, 2 * st[0], st[0]),),
                             (lo + torch.sqrt(u2) + u2 + 1.0,), WIDEN_STEPS)
    hi = widen[-1][0]
    newton, newton_bits = _run(_nu_step(g_and_gp), (0.5 * (lo + hi), lo, hi, g(lo), g(hi)),
                               NU_STEPS)
    lam = newton[-1][0]
    inactive = u2 <= s
    x = torch.where(inactive[..., None], v, v / (1.0 + 2.0 * lam[..., None]))
    t = torch.where(inactive, s, s + lam)
    for a, b in zip((x, t), registry._epi_sum_square_reference(v, s)):
        assert torch.equal(_bits(a), _bits(b))
    return widen_bits, newton_bits, ~inactive


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(400, 200), (400, 10), (64, 1), (64, 33)])
def test_sum_square_widening_repeats_at_its_first_step(rows, n, dtype):
    """hi0 = lo + sqrt(u2) + u2 + 1 with lo = max(0, -s) gives s + hi0 >=
    u2 + 1, so g(hi0) > 0 on every finite row and the widening leaves hi as
    it is: its state repeats at step 1 (period 1), on inactive rows, s <= 0
    and rows with NaN and +-inf as well (where g is NaN or +inf, so hi
    stays too)."""
    v, s = _sum_square_rows(rows, n, dtype, seed=rows + n)
    widen_bits, _, active = _sum_square_loops(v, s)
    k, p = _first_repeat(widen_bits)
    assert (k == 1).all() and (p == 1).all()
    assert (~active).any() and (s <= 0).any()
    _exit_is_exact(widen_bits)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(400, 200), (400, 10)])
def test_sum_square_newton_exit_is_exact(rows, n, dtype):
    """The safeguarded Newton on K4's cubic repeats its state (x, lo, hi,
    glo, ghi) within its 25 steps on most active rows (period 2-4 once x
    settles at the root, as on the LOG_SUM_EXP prox's nu), and the state
    the exit returns is the full count's, bitwise."""
    v, s = _sum_square_rows(rows, n, dtype, seed=rows + n + 1)
    _, newton_bits, active = _sum_square_loops(v, s)
    _exit_is_exact(newton_bits)
    k, p = _first_repeat(newton_bits)
    finite = active & torch.isfinite(v).all(dim=-1) & torch.isfinite(s)
    assert (k[finite] > 0).double().mean().item() > 0.4
    assert set(p[finite & (k > 0)].tolist()) <= {2, 3, 4}


# -- two rows a warp: 16-wide against 32-wide xor butterflies ----------------

def _tmax(a, b):
    """row_loops.cuh tmax (torch.maximum's NaN rule)."""
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, torch.where(a > b, a, b))


def _tmin(a, b):
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, torch.where(a < b, a, b))


BUTTERFLIES = {"sum": (torch.add, 0.0), "max": (_tmax, -np.inf), "min": (_tmin, np.inf)}


def _butterfly(lanes, width, op):
    """Every lane's value after row_loops.cuh's xor butterfly over segments
    of ``width`` lanes (``lanes``: (..., 32))."""
    index = torch.arange(32)
    off = width // 2
    while off:
        lanes = op(lanes, lanes[..., index ^ off])
        off //= 2
    return lanes


def _warp_rows(values, n, identity):
    """Rows of n (..., 2, n) as lanes: one row a warp, (..., 2, 32), each
    row in lanes 0..n-1 of its own warp, and two rows a warp, (..., 32),
    the rows in lanes 0..n-1 and 16..16+n-1; the other lanes hold the
    reduction's identity."""
    one = torch.full(values.shape[:-1] + (32,), identity, dtype=values.dtype)
    one[..., :n] = values
    two = torch.full(values.shape[:-2] + (32,), identity, dtype=values.dtype)
    two[..., :n] = values[..., 0, :]
    two[..., 16:16 + n] = values[..., 1, :]
    return one, two


def _lane_values(n, dtype, seed):
    """A lane's operands: seeded values over many magnitudes (so that the
    order of the sums matters), with zeros of both signs, NaN and +-inf."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((400, 2, n)) * 10.0 ** rng.uniform(-8, 8, (400, 2, n))
    x[rng.rand(400, 2, n) < 0.1] = 0.0
    x[rng.rand(400, 2, n) < 0.1] = -0.0
    x[:4, 0, 0] = (np.nan, np.inf, -np.inf, -0.0)
    x[4, :, :] = -0.0
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", list(range(1, 17)))
def test_half_warp_butterflies_match_one_row_a_warp(n, dtype):
    """For rows of n <= 16 the 32-wide butterfly's first level adds only
    the identities held by lanes n..31 and is the 16-wide butterfly after
    that, so lane j of a row gets the same bits in both: for the sums as
    the kernels form them (a lane's partial sum begins at +0, so it is
    never -0), the max and the min (whose lanes may differ among
    themselves in the sign of a zero, +0 against -0 being a tie, but
    alike in both layouts).  A raw -0 operand is the one case that
    differs: -0 + +0 is +0, so a row of 16 -0s sums to +0 one row a warp
    and to -0 two rows a warp (a shorter row meets a lane holding +0 in
    both)."""
    x = _lane_values(n, dtype, seed=n)
    for kind, (op, identity) in BUTTERFLIES.items():
        operands = 0.0 + x if kind == "sum" else x     # the kernels' partials: +0 + x
        one, two = _warp_rows(operands, n, identity)
        wide = _butterfly(one, 32, op)
        half = _butterfly(two, 16, op)
        for r, lanes in enumerate((slice(0, 16), slice(16, 32))):
            assert torch.equal(_bits(half[..., lanes].contiguous()),
                               _bits(wide[..., r, :16].contiguous()))
    # raw -0 operands: the one difference, as it behaves
    one, two = _warp_rows(x[4:5], n, 0.0)
    wide, half = _butterfly(one, 32, torch.add), _butterfly(two, 16, torch.add)
    assert torch.equal(_bits(wide), _bits(torch.zeros_like(wide)))
    assert torch.equal(_bits(half), _bits(torch.full_like(half, -0.0 if n == 16 else 0.0)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("loop", ["lambert", "sum_square_newton"])
def test_exit_after_cycling_on_is_exact(loop, dtype):
    """Two rows a warp stop together: a row whose state repeated first
    steps on through its cycle (``_cycled_exit_is_exact``), and the state
    it returns is still the full count's."""
    if loop == "lambert":
        bits = _lambert(_c_grid(dtype))
    else:
        v, s = _sum_square_rows(400, 10, dtype, seed=5)
        bits = _sum_square_loops(v, s)[1]
    _cycled_exit_is_exact(bits)


# -- K9, K10: a widening of the upper end (hi), then Newton ------------------
#
# ``elementwise.prox_sum_kl_div_reference`` (K9, ``csrc/sum_kl_div.cu``)
# doubles hi 60 times where g(hi) < 0, then runs 60 safeguarded Newton
# steps; ``prox_sum_inv_pos_reference`` (K10, ``csrc/sum_inv_pos.cu``) 40
# and 50.  Both kernels stop the widening at its first step that leaves hi
# unchanged (``row_loops.cuh`` widen(): the step is a fixed map of hi
# alone, period 1) and run the Newton's count (an exit as iterate4() does
# it, 60 steps: fifteen whole fours and no tail; 50: twelve and a tail of
# two, is exact too, below, but measured slower on the card).

KL_WIDEN, KL_NEWTON = 60, 60
INV_POS_WIDEN, INV_POS_NEWTON = 40, 50


def _special_pairs():
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0])
    return (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))


def _kl_div_inputs(dtype):
    """u and v over -5..10 with lam over 1e-3..1e3, over -30..60 with lam
    over 1e-6..1e6 (where some roots lie below the bracket and some y
    round below 0), and every pair of NaN, +-inf, 0, -0, +-1e30, 1, -1 and
    50 for u and v with lam 1."""
    rng = np.random.RandomState(15)
    u = [rng.uniform(-5.0, 10.0, 2000), rng.uniform(-30.0, 60.0, 2000)]
    v = [rng.uniform(-5.0, 10.0, 2000), rng.uniform(-30.0, 60.0, 2000)]
    lam = [10.0 ** rng.uniform(-3.0, 3.0, 2000), 10.0 ** rng.uniform(-6.0, 6.0, 2000)]
    su, sv = _special_pairs()
    u, v, lam = u + [su], v + [sv], lam + [np.ones(su.size)]
    return (torch.as_tensor(np.concatenate(a), dtype=dtype) for a in (u, v, lam))


def _kl_div_loops(u, v, lam):
    """The widening's step and start, the Newton's step and start, with the
    plain version's operations; the result after both full counts is
    ``prox_sum_kl_div_reference``'s, bitwise."""
    eps = 1e-13 if u.dtype == torch.float64 else 1e-6

    def g(r):
        return lam * r * r + (v - lam) * r - u + lam * torch.log(r)

    def g_and_gp(r):
        return g(r), 2.0 * lam * r + (v - lam) + lam / r

    def widen(state):
        return (torch.where(g(state[0]) < 0, 2.0 * state[0], state[0]),)

    lo = torch.clamp((lam - v) / lam + eps, min=eps)
    hi0 = (torch.clamp(lo * 2.0, min=1.0),)
    hi = hi0
    for _ in range(KL_WIDEN):
        hi = widen(hi)
    hi = hi[0]
    r0 = torch.minimum(torch.maximum(torch.clamp((0.5 + lam - v) / lam, min=eps), lo), hi)
    newton = (_nu_step(g_and_gp), (r0, lo, hi, g(lo), g(hi)))
    state = newton[1]
    for _ in range(KL_NEWTON):
        state = newton[0](state)
    y = lam * state[0] + v - lam
    x = y * state[0]
    tiny = (torch.abs(u) < eps * eps) & (torch.abs(v) < eps * eps)
    out = (torch.where(tiny, u, x), torch.where(tiny, v, y))
    for a, b in zip(out, ew.prox_sum_kl_div_reference(u, v, lam)):
        assert torch.equal(_bits(a), _bits(b))
    return (widen, hi0), newton


def _inv_pos_inputs(dtype):
    """v over +-10 with lam over 1e-3..1e3, v over +-60 with lam over
    1e-6..1e6, and every pair of NaN, +-inf, 0, -0, +-1e30, 1, -1 and 50
    for v and lam."""
    rng = np.random.RandomState(16)
    v = [rng.uniform(-10.0, 10.0, 2000), rng.uniform(-60.0, 60.0, 2000)]
    lam = [10.0 ** rng.uniform(-3.0, 3.0, 2000), 10.0 ** rng.uniform(-6.0, 6.0, 2000)]
    sv, sl = _special_pairs()
    return (torch.as_tensor(np.concatenate(a + [b]), dtype=dtype) for a, b in ((v, sv), (lam, sl)))


def _inv_pos_loops(v, lam):
    """As ``_kl_div_loops``, for ``prox_sum_inv_pos_reference``."""
    c = ew._cbrt(lam)

    def g(x):
        return x * x * (x - v) - lam

    def g_and_gp(x):
        return g(x), 3.0 * x * x - 2.0 * v * x

    def widen(state):
        return (torch.where(g(state[0]) < 0, 2.0 * state[0], state[0]),)

    hi0 = (torch.clamp(v, min=0.0) + c + 1.0,)
    hi = hi0
    for _ in range(INV_POS_WIDEN):
        hi = widen(hi)
    hi = hi[0]
    lo = torch.full_like(v, 1e-12)
    newton = (_nu_step(g_and_gp), (torch.maximum(v, c), lo, hi, g(lo), g(hi)))
    state = newton[1]
    for _ in range(INV_POS_NEWTON):
        state = newton[0](state)
    assert torch.equal(_bits(state[0]), _bits(ew.prox_sum_inv_pos_reference(v, lam)))
    return (widen, hi0), newton


def _widening_stays_once_it_stops(widen, start, iters):
    """Every state after the first repeat equals the full count's (period
    1): returns the share of elements that stop within the count."""
    _, bits = _run(widen, start, iters)
    k, p = _first_repeat(bits)
    assert bool((p[k > 0] == 1).all())
    for j in range(1, iters + 1):
        stopped = (k > 0) & (k <= j)
        assert torch.equal(bits[j][:, stopped], bits[iters][:, stopped])
    return (k > 0).double().mean().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["sum_kl_div", "sum_inv_pos"])
def test_widening_stays_once_hi_stops(kernel, dtype):
    """K9's and K10's widening: its state is hi alone, so once a step
    leaves hi's bits as they were every later step does (the kernels
    leave the loop there, period 1), on NaN, +-inf and the far range too;
    nearly every element stops within the count on these inputs (K9: where
    lam is tiny and v < 0, g stays below 0 until hi is some 2^50 and the
    loop may run out)."""
    if kernel == "sum_kl_div":
        (widen, start), _ = _kl_div_loops(*_kl_div_inputs(dtype))
        share = _widening_stays_once_it_stops(widen, start, KL_WIDEN)
    else:
        (widen, start), _ = _inv_pos_loops(*_inv_pos_inputs(dtype))
        share = _widening_stays_once_it_stops(widen, start, INV_POS_WIDEN)
    assert share > 0.95


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["sum_kl_div", "sum_inv_pos"])
def test_newton_every_fourth_step_exit_is_exact(kernel, dtype):
    """K9's 60 and K10's 50 Newton steps as iterate4() runs them: the full
    count's state bitwise on every element, and many elements leave early
    on these inputs."""
    if kernel == "sum_kl_div":
        _, (step, state) = _kl_div_loops(*_kl_div_inputs(dtype))
        share, _ = _every4_is_exact(step, state, KL_NEWTON)
    else:
        _, (step, state) = _inv_pos_loops(*_inv_pos_inputs(dtype))
        share, _ = _every4_is_exact(step, state, INV_POS_NEWTON)
    assert share > 0.3


def _lazy_falsi_step(g_and_gp):
    """``_nu_step``'s step with the regula falsi point and its clamp
    computed only on the elements whose Newton point is bad (the rest keep
    the Newton point): the premise of computing them only where a lane of
    a warp takes them (``row_loops.cuh`` newton_element; measured slower
    on the card for K10 and not kept, PERF.md)."""
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
        bad = (xn <= lo) | (xn >= hi) | ~torch.isfinite(xn)
        out = xn.clone()
        b_lo, b_hi, b_glo, b_ghi = lo[bad], hi[bad], glo[bad], ghi[bad]
        denom = b_ghi - b_glo
        d_nz = denom != 0
        mid = 0.5 * (b_lo + b_hi)
        falsi = torch.where(d_nz, (b_lo * b_ghi - b_hi * b_glo)
                            / torch.where(d_nz, denom, torch.ones_like(denom)), mid)
        out[bad] = torch.where(torch.isfinite(falsi),
                               torch.minimum(torch.maximum(falsi, b_lo), b_hi), mid)
        return out, lo, hi, glo, ghi
    return step


@pytest.mark.parametrize("dtype", DTYPES)
def test_inv_pos_falsi_only_where_bad_is_the_plain_step(dtype):
    """K10's Newton (``prox_sum_inv_pos_reference``'s 50 steps) with the
    falsi taken only where ``bad`` holds gives the plain step's state
    bitwise at every step, on seeded inputs, the far range and the special
    values (``_inv_pos_inputs``), and both reach the plain version's x.
    This is the premise of a K10 step that computes the falsi behind a warp
    vote over ``bad``: measured and not kept (``PERF.md``), so it
    guards that design should it be taken up again, not the shipped one."""
    v, lam = _inv_pos_inputs(dtype)
    _, (step, state) = _inv_pos_loops(v, lam)

    def g_and_gp(x):
        return x * x * (x - v) - lam, 3.0 * x * x - 2.0 * v * x

    lazy = _lazy_falsi_step(g_and_gp)
    plain = lazy_state = state
    for _ in range(INV_POS_NEWTON):
        plain, lazy_state = step(plain), lazy(lazy_state)
        for a, b in zip(plain, lazy_state):
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(lazy_state[0]), _bits(ew.prox_sum_inv_pos_reference(v, lam)))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.floats(-40.0, 60.0, allow_nan=False),
                          st.floats(-40.0, 60.0, allow_nan=False),
                          st.floats(-6.0, 6.0, allow_nan=False)), min_size=1, max_size=64),
       st.sampled_from(DTYPES))
def test_kl_div_exits_are_exact_hypothesis(triples, dtype):
    u, v, lam = (torch.tensor(c, dtype=dtype) for c in zip(*triples))
    (widen, start), (step, state) = _kl_div_loops(u, v, 10.0 ** lam)
    _widening_stays_once_it_stops(widen, start, KL_WIDEN)
    _every4_is_exact(step, state, KL_NEWTON)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.floats(-80.0, 80.0, allow_nan=False),
                          st.floats(-6.0, 6.0, allow_nan=False)), min_size=1, max_size=64),
       st.sampled_from(DTYPES))
def test_inv_pos_exits_are_exact_hypothesis(pairs, dtype):
    v = torch.tensor([a for a, _ in pairs], dtype=dtype)
    lam = torch.tensor([10.0 ** b for _, b in pairs], dtype=dtype)
    (widen, start), (step, state) = _inv_pos_loops(v, lam)
    _widening_stays_once_it_stops(widen, start, INV_POS_WIDEN)
    _every4_is_exact(step, state, INV_POS_NEWTON)


# -- K11: the SUM_EXP and SUM_NEG_ENTR proxes' Lambert solve -----------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["sum_exp", "sum_neg_entr"])
def test_w_log_w_prox_exit_is_exact(kind, dtype):
    """K11 (``csrc/w_log_w.cu``) runs ``row_loops.cuh`` solve_w_log_w on
    each element's argument c (SUM_EXP: log(lam) + v; SUM_NEG_ENTR: (v -
    lam)/lam - log(lam)), exiting at the first repeat of period <= 4
    checked every step: the full count's w bitwise on v over +-60 and lam
    over 1e-6..1e6 and on special values, and the prox built on it is the
    plain version's, bitwise."""
    v, lam = _inv_pos_inputs(dtype)
    if kind == "sum_exp":
        c = torch.log(lam) + v
        plain = ew.prox_sum_exp_reference(v, lam)
        w = _lambert(c)
        x = v - util.solve_w_log_w(c)
    else:
        c = (v - lam) / lam - torch.log(lam)
        plain = ew.prox_sum_neg_entr_reference(v, lam)
        w = _lambert(c)
        x = lam * util.solve_w_log_w(c)
    assert torch.equal(_bits(x), _bits(plain))
    share, mean_k, _ = _exit_is_exact(w)
    assert share > 0.95 and mean_k < 10.0
