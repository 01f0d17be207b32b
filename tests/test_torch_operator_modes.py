"""The port's prox operators in every mode against the JAX package's, on
terms compiled from library rows (JAX compiler) and carried across with
``interop``: ``VectorProxOperator`` as prox and as epigraph projection on
vectors, on matrices, on two arguments, per slice (axis mode) and per
coordinate, and ``SecondOrderConeProxOperator``.  Each term's operator of
both two-block solvers is applied to the same seeded input, and its value
(``feval``) is compared on the same seeded argument.

Tolerance: rtol 1e-8, atol 1e-9 (both run the same fixed-count iterations
in f64), except the epigraphs solved by implicit Newton on lambda, atol
1e-5 (see ``test_torch_prox_kernels.py``: the JAX loop can leave lambda
about 1e-5 off where the port stays on the root)."""

import numpy as np
import pytest
import torch

from epsilon_tpu.compiler import compiler as jcompiler
from epsilon_tpu.ir import ProxKind as JKind
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.ops.prox import operator as top
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate
from torch_library_rows import build

_IMPLICIT = {JKind.SUM_EXP, JKind.SUM_LOGISTIC, JKind.SUM_INV_POS, JKind.SUM_NEG_ENTR,
             JKind.SUM_NEG_LOG, JKind.SUM_KL_DIV, JKind.LOG_SUM_EXP, JKind.NEG_LOG_DET}


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _mode(op):
    if isinstance(op, top.SecondOrderConeProxOperator):
        return "soc"
    if not isinstance(op, top.VectorProxOperator):
        return None
    spec, entry = op.spec, op.entry
    shape = ("matrix" if entry.matrix else "two_arg" if entry.nargs == 2
             else "axis" if spec.axis is not None
             else "per_coordinate" if spec.epigraph and entry.elementwise_epi else "vector")
    return ("epi_" if spec.epigraph else "prox_") + shape


CASES = [
    ("covsel", True, {"prox_matrix"}),
    ("robust_pca", True, {"prox_matrix"}),
    ("max_gaussian", True, {"epi_matrix", "prox_vector"}),
    ("infinite_push", True, {"epi_axis"}),
    ("max_softmax", True, {"epi_axis"}),
    ("mnist", True, {"prox_axis"}),
    ("oneclass_svm", True, {"epi_vector"}),
    ("robust_svm", True, {"epi_vector"}),
    ("chebyshev", True, {"soc", "prox_vector"}),
    ("huber", True, {"soc"}),
    ("tv_1d", True, {"prox_vector"}),
    ("quantile", True, {"prox_vector"}),
    ("logreg_l1", True, {"prox_vector"}),
    ("infinite_push", False, {"prox_vector"}),
    ("max_softmax", False, {"epi_per_coordinate"}),
    ("oneclass_svm", False, {"soc"}),
]


@pytest.mark.parametrize("row,use_epigraph,modes", CASES,
                         ids=[f"{r}-{'epi' if e else 'no_epi'}" for r, e, _ in CASES])
def test_term_operators_match_jax(row, use_epigraph, modes, monkeypatch):
    pj, _ = build(row, monkeypatch)
    jprob = jcompiler.compile_problem(pj.expression_problem(), use_epigraph=use_epigraph)
    js = jcreate(jprob, JParams())
    ts = tcreate(interop.prox_problem_from_numpy(jprob), TParams())
    assert len(ts.term_ops) == len(js.term_ops)
    seen = set()
    rng = np.random.RandomState(11)
    for term, op_j, op_t in zip(jprob.terms, js.term_ops, ts.term_ops):
        assert type(op_t).__name__ == type(op_j).__name__
        mode = _mode(op_t)
        if mode is None:
            continue
        seen.add(mode)
        atol = 1e-5 if term.spec.epigraph and term.spec.kind in _IMPLICIT else 1e-9
        v = {k: 2 * rng.randn(n) for k, n in ts.all_dims.items()}
        got = op_t.apply(interop.state_from_numpy(v, v)[0])
        want = op_j.apply(_jbv(v))
        assert sorted(got.keys()) == sorted(want.keys())
        for k in want.keys():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-8, atol=atol,
                                       err_msg=f"{mode} {term.spec.kind.value} {k}")
        if mode != "soc":
            u = {f"arg:{i}": rng.rand(d) + 0.5 for i, d in enumerate(op_t.arg_dims)}
            np.testing.assert_allclose(
                np.asarray(op_t.feval(interop.state_from_numpy(u, u)[0])),
                np.asarray(op_j.feval(_jbv(u))), rtol=1e-9, atol=1e-12)
    assert modes <= seen, (modes, seen)


def _jbv(d):
    import jax.numpy as jnp
    from epsilon_tpu.ops.block import BlockVector
    return BlockVector({k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("epigraph", [False, True], ids=["prox", "epi"])
def test_two_argument_operator_matches_jax(epigraph):
    """SUM_KL_DIV, the one two-argument kernel, which no library row reaches
    (the frontend's rules leave kl_div to the conic fallback, which rejects
    it), on a term built directly: args x, y (and t), isotropic metric."""
    import epsilon_tpu.ir as jir
    from epsilon_tpu.ops import block as jb
    from epsilon_tpu.ops import linop as jl
    from epsilon_tpu.ops.prox import operator as jop
    import epsilon_tpu_torch.ir as tir
    from epsilon_tpu_torch.ops import block as tb
    from epsilon_tpu_torch.ops import linop as tl

    n = 6
    keys = ["x", "y"] + (["t"] if epigraph else [])

    def make(ir, L, B, op_mod):
        sizes = [(n, 1), (n, 1)] + ([(1, 1)] if epigraph else [])
        spec = ir.ProxFunctionSpec(kind=ir.ProxKind.SUM_KL_DIV, epigraph=epigraph,
                                   arg_sizes=sizes)
        dims = [n, n, 1]
        H = B.BlockMatrix({(ir.arg_key(i), k): L.scalar(0.8, dims[i]) for i, k in enumerate(keys)})
        g = B.BlockVector({ir.arg_key(0): np.full(n, 0.1)})
        A = B.BlockMatrix({(k, k): L.scalar(1.3, dims[i]) for i, k in enumerate(keys)})
        return op_mod.create_prox_operator(spec, ir.AffineOperator(H, g),
                                           ir.AffineOperator(A, B.BlockVector()))

    op_j, op_t = make(jir, jl, jb, jop), make(tir, tl, tb, top)
    assert _mode(op_t) == ("epi_two_arg" if epigraph else "prox_two_arg")
    rng = np.random.RandomState(2)
    v = {k: rng.rand(1 if k == "t" else n) + 0.2 for k in keys}
    got, want = op_t.apply(interop.state_from_numpy(v, v)[0]), op_j.apply(_jbv(v))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-8,
                                   atol=1e-5 if epigraph else 1e-9)
    u = {f"arg:{i}": rng.rand(n) + 0.5 for i in range(2)}
    np.testing.assert_allclose(np.asarray(op_t.feval(interop.state_from_numpy(u, u)[0])),
                               np.asarray(op_j.feval(_jbv(u))), rtol=1e-12)


def test_tv_operator_threads_warm_state_like_jax(monkeypatch):
    pj, _ = build("tv_1d", monkeypatch)
    jprob = jcompiler.compile_problem(pj.expression_problem())
    js = jcreate(jprob, JParams())
    ts = tcreate(interop.prox_problem_from_numpy(jprob), TParams())
    for op_j, op_t in zip(js.term_ops, ts.term_ops):
        kj = op_j.kernel_state_init() if hasattr(op_j, "kernel_state_init") else None
        kt = op_t.kernel_state_init() if hasattr(op_t, "kernel_state_init") else None
        assert (kj is None) == (kt is None)
        if kt is None:
            continue
        v = {k: 3 * np.random.RandomState(1).randn(n) for k, n in ts.all_dims.items()}
        xt, st = op_t.apply_stateful(interop.state_from_numpy(v, v)[0], kt)
        xj, sj = op_j.apply_stateful(_jbv(v), kj)
        for k in xj.keys():
            np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9, atol=1e-10)
        assert isinstance(st, torch.Tensor)
