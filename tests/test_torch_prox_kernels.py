"""Every canonical prox kernel of the port against the JAX package's, on the
same seeded inputs in float64: each registry entry's prox (scalar and
per-coordinate lam), epigraph projection and value, and the vector kinds
batched along rows (the port's axis-mode form) against ``jax.vmap`` of the
JAX kernel.

Tolerance: rtol 1e-9 and atol 1e-10 on every output (the kernels run the
same fixed-count iterations; the packages differ only in the rounding of
their elementary functions and sums), with two stated exceptions:

- epigraphs solved by implicit Newton on lambda (``newton_epi``): atol
  1e-5 against the JAX package, plus the port's own optimality residual
  (x = prox(v, t - s) and f(x) = t) at 1e-9.  The JAX loop sends a step
  that lands on the root to its bisection fallback, which can leave lam up
  to about 1e-5 off after its fixed 24 iterations; the port stays on the
  root (ROADMAP watch list).
- the bisection fallback epigraph (kinds without their own): atol 1e-7,
  since the sign of the bisected function next to its root is set by
  rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ir import ProxKind as JKind
from epsilon_tpu.ops.prox import registry as jreg
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ir import ProxKind as TKind
from epsilon_tpu_torch.ops.prox import registry as treg

RTOL, ATOL = 1e-9, 1e-10
N = 7          # vector length
B = 3          # batch rows


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _params(kind, n=N):
    rng = np.random.RandomState(11)
    if kind == JKind.SUM_DEADZONE:
        return dict(M=0.3)
    if kind == JKind.SUM_QUANTILE:
        a = rng.rand(n)
        return dict(alpha=a, beta=1.0 - a)
    if kind == JKind.SUM_LARGEST:
        return dict(k=3)
    return {}


def _tparams(p):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in p.items()}


def _jparams(p):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in p.items()}


# epigraphs solved by implicit Newton on lambda
_IMPLICIT = {JKind.SUM_EXP, JKind.SUM_LOGISTIC, JKind.SUM_INV_POS, JKind.SUM_NEG_ENTR,
             JKind.SUM_NEG_LOG, JKind.SUM_KL_DIV, JKind.LOG_SUM_EXP, JKind.NEG_LOG_DET}

_POSITIVE = {JKind.SUM_INV_POS, JKind.SUM_NEG_ENTR, JKind.SUM_NEG_LOG,
             JKind.SUM_KL_DIV, JKind.NEG_LOG_DET}


def _input(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    if kind in _POSITIVE:
        x = np.abs(x) + 0.3
    return x


def _matrix_input(kind, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(5, 5)
    if kind == JKind.NEG_LOG_DET:
        return A @ A.T + np.eye(5)
    if kind in (JKind.SEMIDEFINITE, JKind.LAMBDA_MAX):
        return A + A.T
    return rng.randn(5, 4)


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _assert_epi_optimal(te, x, s, out, tp):
    """The port's epigraph point solves x = prox(v, t - s) with f(x) = t
    (active case), or is (v, s) itself (inactive case), row by row."""
    *xs, t = out
    xo = xs[0] if len(xs) == 1 else tuple(xs)
    t = np.atleast_1d(np.asarray(t))
    s = np.broadcast_to(np.asarray(s, dtype=float), t.shape)
    xv = x if isinstance(x, tuple) else (x,)
    xov = xo if isinstance(xo, tuple) else (xo,)
    for i in range(t.size):
        def row(a):
            a = torch.as_tensor(a)
            return a[i] if t.size > 1 else a
        lam = t[i] - s[i]
        xi = tuple(row(a) for a in xov)
        if lam <= 1e-12:
            _close(xi, tuple(row(a) for a in xv))
            continue
        vi = tuple(row(a) for a in xv)
        arg = vi if len(vi) == 2 else vi[0]
        _close(te.prox(arg, float(lam), **tp), xi if len(xi) == 2 else xi[0], 1e-9, 1e-9)
        fx = te.feval(xi if len(xi) == 2 else xi[0], **tp)
        np.testing.assert_allclose(float(fx), t[i], rtol=1e-9, atol=1e-9)


def _t(x):
    if isinstance(x, tuple):
        return tuple(torch.as_tensor(a) for a in x)
    return torch.as_tensor(x)


def _j(x):
    if isinstance(x, tuple):
        return tuple(jnp.asarray(a) for a in x)
    return jnp.asarray(x)


def _arg(kind, entry, seed=0):
    if entry.matrix:
        return _matrix_input(kind, seed)
    if entry.nargs == 2:
        return (_input(kind, (N,), seed), _input(kind, (N,), seed + 1))
    return _input(kind, (N,), seed)


def _cases():
    out = []
    for kind, entry in jreg.KERNELS.items():
        if entry.prox is not None:
            out.append((kind, "prox"))
            if entry.elementwise and not entry.matrix:
                out.append((kind, "prox_vector_lam"))
        if entry.epi is not None:
            out.append((kind, "epi_active"))
            out.append((kind, "epi_inactive"))
        elif entry.prox is not None and not entry.matrix and entry.nargs == 1 \
                and kind != JKind.TOTAL_VARIATION_1D:
            out.append((kind, "epi_bisection"))
        out.append((kind, "feval"))
        if not entry.matrix and entry.nargs == 1 and not entry.elementwise_epi \
                and kind != JKind.TOTAL_VARIATION_1D:
            if entry.prox is not None:
                out.append((kind, "prox_batched"))
            if entry.epi is not None:
                out.append((kind, "epi_batched"))
    return [pytest.param(k, f, id=f"{k.value}-{f}") for k, f in out]


@pytest.mark.parametrize("kind,fn", _cases())
def test_kernel_matches_jax(kind, fn):
    je, te = jreg.KERNELS[kind], treg.KERNELS[TKind(kind.value)]
    p = _params(kind)
    jp, tp = _jparams(p), _tparams(p)
    x = _arg(kind, je)
    if fn == "prox":
        _close(te.prox(_t(x), 0.7, **tp), je.prox(_j(x), 0.7, **jp))
    elif fn == "prox_vector_lam":
        lam = np.random.RandomState(5).rand(N) + 0.1
        _close(te.prox(_t(x), torch.as_tensor(lam), **tp), je.prox(_j(x), jnp.asarray(lam), **jp))
    elif fn in ("epi_active", "epi_inactive", "epi_bisection"):
        fv = float(je.feval(_j(x), **jp).sum()) if not je.elementwise_epi else None
        if je.elementwise_epi:
            s = np.exp(x) * (1.5 if fn == "epi_inactive" else 0.5)
            ts, js = torch.as_tensor(s), jnp.asarray(s)
        else:
            s = fv + 1.0 if fn == "epi_inactive" else fv - 1.3
            ts, js = s, s
        tepi = te.epi or treg.epigraph_via_bisection(TKind(kind.value))
        jepi = je.epi or jreg.epigraph_via_bisection(kind)
        got = tepi(_t(x), ts, **tp)
        if kind in _IMPLICIT:
            _close(got, jepi(_j(x), js, **jp), 0, 1e-5)
            _assert_epi_optimal(te, _t(x), ts, got, tp)
        else:
            _close(got, jepi(_j(x), js, **jp), RTOL, 1e-7 if fn == "epi_bisection" else ATOL)
            assert got[-1].dtype == torch.float64
    elif fn == "feval":
        if je.elementwise_epi:
            _close(te.feval(_t(x), **tp), je.feval(_j(x), **jp))
        else:
            _close(float(te.feval(_t(x), **tp)), float(je.feval(_j(x), **jp)))
    elif fn == "prox_batched":
        X = _input(kind, (B, N), seed=3)
        want = jax.vmap(lambda r: je.prox(r, 0.7, **jp))(jnp.asarray(X))
        _close(te.prox(torch.as_tensor(X), 0.7, **tp), want)
    else:   # epi_batched: one bound per row, some rows inactive
        X = _input(kind, (B, N), seed=3)
        fv = np.asarray(jax.vmap(lambda r: je.feval(r, **jp))(jnp.asarray(X)))
        s = fv + np.array([-1.3, 0.5, -0.2])
        want = jax.vmap(lambda r, si: je.epi(r, si, **jp))(jnp.asarray(X), jnp.asarray(s))
        got = te.epi(torch.as_tensor(X), torch.as_tensor(s), **tp)
        if kind in _IMPLICIT:
            _close(got, want, 0, 1e-5)
            _assert_epi_optimal(te, torch.as_tensor(X), s, got, tp)
        else:
            _close(got, want)


def test_every_jax_kernel_is_registered():
    assert {k.value for k in jreg.KERNELS} == {k.value for k in treg.KERNELS}
    for kind, je in jreg.KERNELS.items():
        te = treg.KERNELS[TKind(kind.value)]
        assert (te.elementwise, te.matrix, te.nargs, te.elementwise_epi) == \
            (je.elementwise, je.matrix, je.nargs, je.elementwise_epi)
        assert (te.epi is None) == (je.epi is None)
        assert (te.stateful_prox is None) == (je.stateful_prox is None)


@pytest.mark.parametrize("lam", [1e-6, 1e-2, 1.0, 1e3, 1e6])
def test_log_sum_exp_prox_across_lam(lam):
    x = _input(JKind.LOG_SUM_EXP, (N,), seed=4) * 3
    _close(treg.KERNELS[TKind.LOG_SUM_EXP].prox(_t(x), lam),
           jreg.KERNELS[JKind.LOG_SUM_EXP].prox(_j(x), lam))


def test_pwl_root_plateau_and_batch():
    from epsilon_tpu.ops.prox import util as ju
    from epsilon_tpu_torch.ops.prox import util as tu
    keys = np.array([[3.0, 1.0, 1.0, -2.0], [0.5, 0.5, 0.5, 0.5]])
    w = np.array([[1.0, 2.0, 1.0, 1.0], [1.0, -1.0, 1.0, -1.0]])
    c0 = np.array([-2.0, 0.0])
    want = [float(ju.pwl_root(c0[i], 0.0, jnp.asarray(keys[i]), jnp.asarray(w[i])))
            for i in range(2)]
    got = tu.pwl_root(torch.as_tensor(c0), 0.0, torch.as_tensor(keys), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
