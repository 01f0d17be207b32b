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


def make_consensus_lasso(P, As, bs, lam=0.3, via_y=False, kind="SUM_SQUARE",
                         tv=False):
    """min sum_i 0.5||A_i x_i - b_i||^2 + lam||z||_1  s.t. x_i = z: lasso
    on the row-stacked system.  ``via_y`` moves an objective-neutral mirror
    variable y behind a KEPT constraint z = y, which exercises the
    sqrt(S+1) metric weight of the reduced projection.  With another
    ``kind`` the private terms are ``0.1 kind(x_i - c_i)`` (c_i the first n
    entries of b_i): a stacked vector kernel.  ``tv`` adds ``0.05 TV(v)``
    on one more copy v = z: a family of one, so a bucket term with a warm
    kernel state beside the stacked group."""
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
    if tv:
        terms.append(_term(P, "TOTAL_VARIATION_1D", 0.05, "v",
                           P.linop.identity(n)))
        var_dims["v"] = n
        cons.append(_tie(P, "cv", "v", "z", n))
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


def _perm(rng, n, P):
    """A sparse n x n permutation with entries of one random sign each."""
    import scipy.sparse as sp
    cols = rng.permutation(n)
    return P.linop.sparse(sp.csr_matrix(
        (np.where(rng.rand(n) < 0.5, -1.0, 1.0), (np.arange(n), cols)),
        shape=(n, n)))


def make_family_problem(P, family, S=8, seed=0, lam=0.3, size=None,
                        shared="NORM_1"):
    """S private terms of one kind of vector operator, each over its own
    variable w_i tied to z by ``w_i - z = 0``, and ``lam ||z||_1``.  The
    family names the operator's mode: ``epigraph`` (the ball ||w - c_i||
    <= r_i: the NORM_2 epigraph with t = r_i from the offset),
    ``epigraph_elementwise`` (exp(w - c_i) <= t_i per coordinate),
    ``matrix`` (nuclear norm of mat(w - c_i), 3 x 4), ``slices`` (the
    2-norm of each row of mat(w - c_i), 3 x 4), ``two_arg`` (KL divergence
    of w + c_i from a constant y_i), ``sparse`` (||P_i w - c_i||_1 with P_i
    a signed permutation of 300, too sparse to densify), ``kron``
    (||(P_i (x) Q_i) w - c_i||_1, P_i 3 x 3 and Q_i 4 x 4), ``tv``
    (0.1 TV(w - c_i), c_i a random walk) and ``tv_epigraph`` (TV(w - c_i)
    <= r_i).  ``size`` scales them: the
    length d of w (``(p, q)`` for matrix, slices and kron).  ``shared`` is
    the kind of z's term: SUM_SQUARE makes the problem strongly convex, so
    that its minimiser is unique and two solves that round differently
    cannot drift apart along a flat direction.  A term has
    arguments from one variable only when the others come from the offset:
    selectors of one variable into two arguments leave off-diagonal blocks
    that neither package's operator accepts."""
    rng = np.random.RandomState(seed)
    L = P.linop
    a0, a1 = P.arg_key(0), P.arg_key(1)
    spec = dict(kind=P.ProxKind.NORM_1, alpha=0.1)
    blocks = lambda i: {(a0, f"w{i}"): L.identity(d)}
    if family in ("matrix", "slices", "kron"):
        p, q = size or (3, 4)
        d = p * q
    else:
        d = size or dict(sparse=300).get(family, 6)
    if family == "epigraph":
        spec = dict(kind=P.ProxKind.NORM_2, alpha=1.0, epigraph=True,
                    arg_sizes=[(d, 1), (1, 1)])
        offset = lambda: {a0: rng.randn(d), a1: 0.5 + rng.rand(1)}
    elif family == "epigraph_elementwise":
        spec = dict(kind=P.ProxKind.EXP, alpha=1.0, epigraph=True,
                    arg_sizes=[(d, 1), (d, 1)])
        offset = lambda: {a0: 0.3 * rng.randn(d), a1: 0.5 + rng.rand(d)}
    elif family in ("matrix", "slices"):
        spec = dict(kind=P.ProxKind.NORM_NUCLEAR, alpha=0.2, arg_sizes=[(p, q)])
        if family == "slices":
            spec = dict(kind=P.ProxKind.NORM_2, alpha=0.2, arg_sizes=[(p, q)],
                        axis=1)
        offset = lambda: {a0: rng.randn(d)}
    elif family == "two_arg":
        spec = dict(kind=P.ProxKind.SUM_KL_DIV, alpha=0.1,
                    arg_sizes=[(d, 1), (d, 1)])
        offset = lambda: {a0: 1.0 + rng.rand(d), a1: 0.5 + rng.rand(d)}
    elif family == "sparse":
        blocks = lambda i: {(a0, f"w{i}"): _perm(rng, d, P)}
        offset = lambda: {a0: rng.randn(d)}
    elif family == "kron":
        blocks = lambda i: {(a0, f"w{i}"): L.kronecker(_perm(rng, p, P),
                                                       _perm(rng, q, P))}
        offset = lambda: {a0: rng.randn(d)}
    elif family == "tv":
        spec = dict(kind=P.ProxKind.TOTAL_VARIATION_1D, alpha=0.1)
        offset = lambda: {a0: -np.cumsum(0.1 * rng.randn(d))}
    elif family == "tv_epigraph":
        spec = dict(kind=P.ProxKind.TOTAL_VARIATION_1D, alpha=1.0, epigraph=True,
                    arg_sizes=[(d, 1), (1, 1)])
        offset = lambda: {a0: -np.cumsum(0.1 * rng.randn(d)), a1: 0.5 + rng.rand(1)}
    else:
        raise ValueError(family)
    terms, cons, var_dims = [], [], {"z": d}
    for i in range(S):
        terms.append(P.ProxTerm(
            spec=P.ProxFunctionSpec(**spec),
            H=P.AffineOperator(P.BlockMatrix(blocks(i)),
                               P.BlockVector(offset()))))
        cons.append(_tie(P, f"t{i}", f"w{i}", "z", d))
        var_dims[f"w{i}"] = d
    terms.append(_term(P, shared, lam, "z", P.linop.identity(d)))
    return P.ProxProblem(terms=terms, constraints=cons, var_dims=var_dims,
                         var_shapes={k: (n, 1) for k, n in var_dims.items()})


FAMILIES = ["epigraph", "epigraph_elementwise", "matrix", "slices", "two_arg",
            "sparse", "kron"]


def problems(P):
    """Every problem of the two JAX test files by name, each a function
    that makes it with the IR namespace ``P``, and the families that stack
    an operator of each other kind."""
    fams = {f"family_{f}": (lambda f=f: make_family_problem(P, f))
            for f in FAMILIES + ["tv_epigraph"]}
    return fams | {
        "consensus8_wide": lambda: make_consensus_lasso(
            P, *consensus_data(S=8, m=4, n=40)),
        "consensus8_tv": lambda: make_consensus_lasso(
            P, *consensus_data(), kind="TOTAL_VARIATION_1D"),
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


# Solver parameters of the problems above that stack an operator of a kind
# added after the first meshed slice: the tolerances of the other cases,
# the iterations capped where a family takes long (two solves are compared
# iteration by iteration, which needs no convergence).
KIND_SOLVES = {
    name: dict(rel_tol=1e-6, abs_tol=1e-8, max_iterations=cap)
    for name, cap in [("consensus8_wide", 30), ("consensus8_tv", 30),
                      ("family_epigraph", 4000),
                      ("family_epigraph_elementwise", 30),
                      ("family_matrix", 30), ("family_slices", 30),
                      ("family_two_arg", 20), ("family_sparse", 30),
                      ("family_kron", 30)]}
