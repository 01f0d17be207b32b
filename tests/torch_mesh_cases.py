"""Problems of the meshed two-block tests, built from a numpy seed with the
IR of either package: the problems of ``tests/test_term_sharding.py`` and
``tests/test_scenario.py``.  ``ns(package_name)`` loads the package's IR by
name, so this file imports neither package itself (the worker processes
load the port alone).  Offsets are host numpy in both packages, so that the
JAX package lifts them as arguments."""

import importlib
import types

import numpy as np


def ns(package: str):
    """The IR names of ``package`` (``epsilon_tpu`` or its port)."""
    ir = importlib.import_module(package + ".ir")
    out = types.SimpleNamespace(
        linop=importlib.import_module(package + ".ops.linop"))
    for name in ("AffineOperator", "Cone", "ConeConstraint", "ProxFunctionSpec",
                 "ProxKind", "ProxProblem", "ProxTerm", "arg_key"):
        setattr(out, name, getattr(ir, name))
    block = importlib.import_module(package + ".ops.block")
    out.BlockMatrix, out.BlockVector = block.BlockMatrix, block.BlockVector
    return out


def _term(P, kind, alpha, var, op, b=None):
    return P.ProxTerm(
        spec=P.ProxFunctionSpec(kind=getattr(P.ProxKind, kind), alpha=alpha),
        H=P.AffineOperator(
            P.BlockMatrix({(P.arg_key(0), var): op}),
            P.BlockVector({} if b is None else {P.arg_key(0): np.asarray(b)})))


def _tie(P, row, x, z, n):
    """x - z = 0."""
    return P.ConeConstraint(cone=P.Cone.ZERO, op=P.AffineOperator(
        P.BlockMatrix({(row, x): P.linop.identity(n),
                       (row, z): P.linop.scalar(-1.0, n)}), P.BlockVector()))


def lasso_data(seed, m, n, scale=1.0, density=0.3):
    rng = np.random.RandomState(seed)
    A = scale * rng.randn(m, n)
    b = A @ (rng.randn(n) * (rng.rand(n) < density)) + 0.1 * rng.randn(m)
    return A, b


def make_lasso_problem(P, A, b, lam):
    n = A.shape[1]
    return P.ProxProblem(
        terms=[_term(P, "SUM_SQUARE", 0.5, "x", P.linop.dense(A), -b),
               _term(P, "NORM_1", lam, "y", P.linop.identity(n))],
        constraints=[_tie(P, "c", "x", "y", n)],
        var_dims={"x": n, "y": n}, var_shapes={"x": (n, 1), "y": (n, 1)})


def make_multi_term_problem(P, seed=0, n=12, n_groups=4, tv=False):
    """min sum_square(A x - b) + sum_g lam_g ||x_g||_2 over groups +
    norm1(y)  s.t. x = y: a heterogeneous mix of KKT, vector and
    elementwise terms sharing consensus variables.  ``tv`` adds a
    total-variation term on a copy of x (a kernel with warm state)."""
    rng = np.random.RandomState(seed)
    m = 3 * n
    A = rng.randn(m, n)
    x_true = rng.randn(n) * (rng.rand(n) < 0.5)
    b = A @ x_true + 0.05 * rng.randn(m)
    gs = n // n_groups
    terms = [_term(P, "SUM_SQUARE", 0.5, "x", P.linop.dense(A), -b),
             _term(P, "NORM_1", 0.2, "y", P.linop.identity(n))]
    cons = [_tie(P, "c", "x", "y", n)]
    var_dims = {"x": n, "y": n}
    for g in range(n_groups):
        terms.append(_term(P, "NORM_2", 0.1, f"w{g}", P.linop.identity(gs)))
        sel = np.zeros((gs, n))
        sel[np.arange(gs), g * gs + np.arange(gs)] = 1.0
        cons.append(P.ConeConstraint(cone=P.Cone.ZERO, op=P.AffineOperator(
            P.BlockMatrix({(f"cw{g}", "x"): P.linop.dense(sel),
                           (f"cw{g}", f"w{g}"): P.linop.scalar(-1.0, gs)}),
            P.BlockVector())))
        var_dims[f"w{g}"] = gs
    if tv:
        terms.append(_term(P, "TOTAL_VARIATION_1D", 0.05, "v",
                           P.linop.identity(n)))
        cons.append(_tie(P, "cv", "v", "x", n))
        var_dims["v"] = n
    return P.ProxProblem(terms=terms, constraints=cons, var_dims=var_dims,
                         var_shapes={k: (d, 1) for k, d in var_dims.items()})


def make_hetero_16term_problem(P, seed=0, n=16):
    """16 mixed-kernel terms with per-term dense data in the separated form
    the compiler guarantees (every variable in exactly ONE term; copies
    tied to the consensus variable by identity ZERO constraints).  14
    SUM_SQUARE terms: 14 is no multiple of 4 or 8, so they do not stack."""
    rng = np.random.RandomState(seed)
    terms = [_term(P, "NORM_1", 0.02, "x", P.linop.identity(n))]
    cons = []
    var_dims = {"x": n}
    for i in range(14):
        mi = 20 + 2 * i
        A = rng.randn(mi, n) / np.sqrt(mi)
        b = A @ (rng.randn(n) * (rng.rand(n) < 0.5)) + 0.05 * rng.randn(mi)
        terms.append(_term(P, "SUM_SQUARE", 0.5, f"x{i}", P.linop.dense(A), -b))
        cons.append(_tie(P, f"c{i}", f"x{i}", "x", n))
        var_dims[f"x{i}"] = n
    terms.append(_term(P, "NORM_2", 0.02, "y", P.linop.identity(n)))
    cons.append(_tie(P, "cy", "y", "x", n))
    var_dims["y"] = n
    return P.ProxProblem(terms=terms, constraints=cons, var_dims=var_dims,
                         var_shapes={k: (d, 1) for k, d in var_dims.items()})


def consensus_data(seed=0, S=8, m=12, n=6):
    rng = np.random.RandomState(seed)
    As = [rng.randn(m, n) for _ in range(S)]
    x_true = rng.randn(n) * (rng.rand(n) < 0.5)
    bs = [A @ x_true + 0.05 * rng.randn(m) for A in As]
    return As, bs


def make_consensus_lasso(P, As, bs, lam=0.3, via_y=False, kind="SUM_SQUARE"):
    """min sum_i 0.5||A_i x_i - b_i||^2 + lam||z||_1  s.t. x_i = z: lasso
    on the row-stacked system.  ``via_y`` moves an objective-neutral mirror
    variable y behind a KEPT constraint z = y, which exercises the
    sqrt(S+1) metric weight of the reduced projection.  With another
    ``kind`` the private terms are ``0.1 kind(x_i - c_i)`` (c_i the first n
    entries of b_i): a stacked vector kernel."""
    n = As[0].shape[1]
    terms, cons = [], []
    var_dims = {"z": n}
    for i, (A, b) in enumerate(zip(As, bs)):
        if kind == "SUM_SQUARE":
            terms.append(_term(P, kind, 0.5, f"x{i}", P.linop.dense(A), -b))
        else:
            terms.append(_term(P, kind, 0.1, f"x{i}", P.linop.identity(n),
                               -b[:n]))
        cons.append(_tie(P, f"t{i}", f"x{i}", "z", n))
        var_dims[f"x{i}"] = n
    terms.append(_term(P, "NORM_1", lam, "z", P.linop.identity(n)))
    if via_y:
        terms.append(_term(P, "CONSTANT", 1.0, "y", P.linop.identity(n)))
        var_dims["y"] = n
        cons.append(_tie(P, "cy", "z", "y", n))
    return P.ProxProblem(terms=terms, constraints=cons, var_dims=var_dims,
                         var_shapes={k: (d, 1) for k, d in var_dims.items()})


def two_family_data(seed=0, S1=4, S2=4, m1=12, m2=20, n=6):
    rng = np.random.RandomState(seed)
    x_true = rng.randn(n) * (rng.rand(n) < 0.5)
    As, bs = [], []
    for S, m in ((S1, m1), (S2, m2)):
        for _ in range(S):
            A = rng.randn(m, n)
            As.append(A)
            bs.append(A @ x_true + 0.05 * rng.randn(m))
    return As, bs


def problems(P):
    """Every problem of the two JAX test files by name, each a function
    that makes it with the IR namespace ``P``."""
    return {
        "multi_term": lambda: make_multi_term_problem(P),
        "multi_term_16_8": lambda: make_multi_term_problem(P, n=16, n_groups=8),
        "lasso_30_15": lambda: make_lasso_problem(P, *lasso_data(0, 30, 15), 0.5),
        "hetero16": lambda: make_hetero_16term_problem(P),
        "consensus8": lambda: make_consensus_lasso(P, *consensus_data()),
        "consensus8_via_y": lambda: make_consensus_lasso(
            P, *consensus_data(), via_y=True),
        "consensus8_32_16": lambda: make_consensus_lasso(
            P, *consensus_data(S=8, m=32, n=16)),
        "consensus6": lambda: make_consensus_lasso(P, *consensus_data(S=6)),
        "consensus12": lambda: make_consensus_lasso(P, *consensus_data(S=12)),
        "two_family": lambda: make_consensus_lasso(P, *two_family_data()),
    }
