"""One rank of the meshed paths that ``chip_smoke.py`` drives in its phase 9.

    python3 tools/mesh_worker.py run <rank> <world> <rendezvous_file> <out_dir>
    python3 tools/mesh_worker.py resume <rank> <world> <rendezvous_file> <out_dir>
    python3 tools/mesh_worker.py probe [world]

The second form starts ``world`` (4) ranks of itself and prints two
measurements behind phase 9's figures: the time of one all-reduce over the
group, CUDA and CPU tensors, and part (a)'s optimality (KKT/lambda in f64
numpy) down a ladder of tolerances, each solve going on warm from the
last.

Every rank runs the same four parts on the card, over one process group
(``initialize_distributed`` picks the backend: NCCL with a card a rank where
the machine has as many cards as ranks, otherwise gloo with CUDA tensors on
card 0), and writes ``<out_dir>/rank<r>.json`` and ``rank<r>.npz``; the
caller holds the results to its references.

(a) Scenario stacking at full width: BASELINE config[4] (200 blocks of
    2500 x 200, seed 0, lambda 0.1, rho 1, f32) stated as a general problem
    — 200 SUM_SQUARE terms over private variables tied to one z by identity
    constraints, NORM_1 on z — through ``Problem.solve(mesh=group)``.
(b) Term buckets at full width: the heterogeneous problem of
    ``tests/test_term_sharding.py`` at n = 2048 with 64 groups (A 6144 x
    2048; one SUM_SQUARE, one NORM_1, 64 NORM_2 terms, 65 constraints); then
    the flagship lasso 2000 x 1000 (two terms: two empty buckets on four
    ranks).
(c) ``solver="prox_admm"`` with the group on the flagship lasso (rewritten
    to the two-block solver), and adaptive rho with the group on (b)'s
    problem.
(d) The sharded consensus solve (``consensus_lasso_solver(..., group=)``,
    the fused local-update kernel on every rank's blocks) for 500
    iterations.
(e) Wide scenarios: 64 blocks of 200 x 2000 (fewer rows than features,
    ``consensus_blocks``' generator, seed 0, f32) with NORM_1 on z at
    lambda 0.1, through ``Problem.solve(mesh=group)``: every SUM_SQUARE term
    keeps its factored KKT chain (the collapsed solve would not be smaller)
    and the 64 stack as one group.
(f) One consensus family per operator kind stacked since (``FAMILIES``,
    ``tests/torch_mesh_cases.make_family_problem`` at the sizes of
    ``FULL["kinds"]``), 8 scenarios, at most ``FULL["kind_iters"]``
    iterations each; each family's record holds the launches of the hand
    loop kernels K6 and K7 during its solve (the TV family runs K7).
(g) (e)'s problem stopped after ``CKPT_EPOCHS`` epochs under
    ``drive="host"`` with a checkpointer in ``<out_dir>/ckpt``, and resumed
    by a new solver on the same ranks; the ``resume`` form resumes the same
    checkpoint on another number of ranks (it writes ``resume<r>.json`` and
    ``.npz``).
"""

import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# steady_iters: (a)'s, (b)'s and (e)'s warm re-solves, whole epochs of 50
# (the device drive rounds a count down to whole epochs, and up to one)
# kind_iters: (f)'s iteration caps; the matrix and per-slice families run
# to convergence (about 70 iterations in f32 on the CPU), the others stop
# sooner, short of it where a call costs most (TV-1D's PDAS, the
# two-argument and exp epigraph Newton loops)
FULL = dict(consensus=(200, 2500, 200), hetero=(2048, 64), flagship=(2000, 1000),
            consensus_iters=500, steady_iters=dict(a=50, b=50, e=50),
            wide=(64, 200, 2000), kind_S=8,
            kinds=dict(tv=10000, epigraph=10000, epigraph_elementwise=10000,
                       matrix=(64, 64), slices=(100, 100), two_arg=10000,
                       sparse=10000, kron=(100, 100)),
            kind_iters=dict(tv=10, epigraph=60, epigraph_elementwise=10,
                            matrix=200, slices=200, two_arg=10, sparse=20,
                            kron=20))
LAM, RHO = 0.1, 1.0
SOLVE = dict(rel_tol=1e-3, abs_tol=1e-6, rho=1.0)
# (a): the general two-block splitting gives the NORM_1 term one copy among
# the 201 of the consensus average, so it converges more slowly than the
# consensus solver with its exact global prox, and its stop test lets go
# earlier: on an H100 in f32 at rho 1, KKT/lambda was 1.25e-1 at rel_tol 1e-5
# (450 iterations), 3.6e-2 at 3e-6 (650), 8.6e-3 at 1e-6 (870) and 7.0e-4 at
# 3e-7 (1,090); the gate is 1e-2 (``probe`` prints the ladder).
TIGHT = dict(rel_tol=3e-7, abs_tol=1e-9, rho=RHO, max_iterations=5000)
STEADY_REPS = 3
# (e) and (g): the wide family's solve (about 110 iterations); (f): each
# family's, with its cap from ``kind_iters``
WIDE = dict(rel_tol=1e-3, abs_tol=1e-6, rho=RHO, max_iterations=3000)
KINDS = dict(rel_tol=1e-3, abs_tol=1e-6, rho=RHO)
CKPT_EPOCHS = 3
WIDE_IDS = 10 ** 6    # (e)'s variables count their ids from here


def workload(m, n, seed=0):
    """The flagship generator (bench.py's lasso workload)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()
    return A, b, lam


@functools.lru_cache(maxsize=1)
def consensus_blocks(S, m, n):
    """bench.py's consensus data, made once for parts (a) and (d)."""
    from epsilon_tpu_torch.problems.scaling_bench import make_blocks
    return make_blocks(S, m, n)


def consensus_problem(ep, A, b, lam, first_id=None):
    """sum_i 1/2 ||A_i x_i - b_i||^2 + lam ||z||_1  s.t.  x_i = z, with the
    modeling API: ``(problem, z, [x_i])``.  With ``first_id`` the variables'
    ids count from it, so that two processes compile the same variable
    names (a checkpoint's state carries them)."""
    if first_id is not None:
        import itertools
        from epsilon_tpu_torch.frontend import expression
        expression._COUNTER = itertools.count(first_id)
    S, _, n = A.shape
    z = ep.Variable(n)
    xs = [ep.Variable(n) for _ in range(S)]
    obj = lam * ep.norm1(z)
    for i, x in enumerate(xs):
        obj = obj + 0.5 * ep.sum_squares(ep._wrap(A[i].astype(np.float64)) * x
                                         - b[i].astype(np.float64))
    return ep.Problem(ep.Minimize(obj), [x == z for x in xs]), z, xs


def mesh_cases():
    """``tests/torch_mesh_cases.py`` (the meshed tests' problems, built with
    the port's IR): ``(module, IR namespace)``."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    import torch_mesh_cases as mc
    return mc, mc.ns("epsilon_tpu_torch")


def kind_problem(family, sizes):
    """(f)'s problem of one family, with a sum of squares on z: strongly
    convex, so the meshed and the one-process solve, which round in
    another order, cannot drift apart along a flat direction (with NORM_1
    on z the per-slice family's did by 3e-2 in f32)."""
    mc, P = mesh_cases()
    return mc.make_family_problem(P, family, S=sizes["kind_S"],
                                  size=sizes["kinds"][family], shared="SUM_SQUARE")


def flat_x(x):
    """A solution's blocks, in sorted key order, as one f64 array."""
    return np.concatenate([x[k].detach().cpu().numpy().astype(np.float64).ravel()
                           for k in sorted(x.keys())])


def hetero_problem(n, n_groups, seed=0):
    """min 1/2 ||A x - b||^2 + sum_g 0.1 ||x_g||_2 over groups + 0.2
    ||y||_1  s.t. x = y: a heterogeneous mix of KKT, vector and elementwise
    terms sharing consensus variables (``tests/test_term_sharding.py``'s
    problem, at any size)."""
    from epsilon_tpu_torch.ir import (AffineOperator, Cone, ConeConstraint,
                                      ProxFunctionSpec, ProxKind, ProxProblem,
                                      ProxTerm, arg_key)
    from epsilon_tpu_torch.ops import linop
    from epsilon_tpu_torch.ops.block import BlockMatrix, BlockVector

    def term(kind, alpha, var, op, b=None):
        return ProxTerm(
            spec=ProxFunctionSpec(kind=kind, alpha=alpha),
            H=AffineOperator(BlockMatrix({(arg_key(0), var): op}),
                             BlockVector({} if b is None else {arg_key(0): b})))

    rng = np.random.RandomState(seed)
    m = 3 * n
    A = rng.randn(m, n)
    x_true = rng.randn(n) * (rng.rand(n) < 0.5)
    b = A @ x_true + 0.05 * rng.randn(m)
    gs = n // n_groups
    terms = [term(ProxKind.SUM_SQUARE, 0.5, "x", linop.dense(A), -b),
             term(ProxKind.NORM_1, 0.2, "y", linop.identity(n))]
    cons = [ConeConstraint(cone=Cone.ZERO, op=AffineOperator(
        BlockMatrix({("c", "x"): linop.identity(n),
                     ("c", "y"): linop.scalar(-1.0, n)}), BlockVector()))]
    var_dims = {"x": n, "y": n}
    for g in range(n_groups):
        terms.append(term(ProxKind.NORM_2, 0.1, f"w{g}", linop.identity(gs)))
        sel = np.zeros((gs, n))
        sel[np.arange(gs), g * gs + np.arange(gs)] = 1.0
        cons.append(ConeConstraint(cone=Cone.ZERO, op=AffineOperator(
            BlockMatrix({(f"cw{g}", "x"): linop.dense(sel),
                         (f"cw{g}", f"w{g}"): linop.scalar(-1.0, gs)}),
            BlockVector())))
        var_dims[f"w{g}"] = gs
    return ProxProblem(terms=terms, constraints=cons, var_dims=var_dims,
                       var_shapes={k: (d, 1) for k, d in var_dims.items()})


def lasso_problem(ep, A, b, lam):
    x = ep.Variable(A.shape[1])
    return x, ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))


def cached_solver(prob):
    from epsilon_tpu_torch.frontend.solve import _PROBLEM_CACHE
    return _PROBLEM_CACHE[prob][1]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _digest(arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _on_device(solver, device_type):
    """Every tensor of the solver's warm state and of its operator data
    lies on the device."""
    z, u = solver._warm_state[:2]
    tensors = list(z.data.values()) + list(u.data.values())
    for g in solver.scn_groups:
        tensors += g.stacks
    return all(t.device.type == device_type for t in tensors)


PROFILE_ITERS = 20


def _steady(solve, iters, solver, profiled: bool):
    """``STEADY_REPS`` warm re-solves of ``iters`` iterations: ms per
    iteration ``[median, min, max]`` and collectives per iteration; then,
    where ``profiled`` (one rank; the others run the same solve beside
    it), the device operations per iteration of one more re-solve of
    ``PROFILE_ITERS`` under ``torch.profiler`` (kernels and copies that ran
    on the card; None on the CPU)."""
    ms = []
    kw = dict(rel_tol=0.0, abs_tol=0.0, epoch_iterations=50)
    before, ran = solver.n_collectives, 0
    for _ in range(STEADY_REPS):
        _sync()
        status = solve(max_iterations=iters, **kw)
        _sync()
        ms.append(status.timing.solve_usec / 1e3 / status.num_iterations)
        ran += status.num_iterations
    out = dict(ms_per_iter=[statistics.median(ms), min(ms), max(ms)],
               collectives_per_iter=(solver.n_collectives - before) / ran,
               device_ops_per_iter=None)
    kw["epoch_iterations"] = 10
    if profiled and torch.cuda.is_available():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(max_iterations=PROFILE_ITERS, **kw)
            _sync()
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        out["device_ops_per_iter"] = n / PROFILE_ITERS
    else:
        solve(max_iterations=PROFILE_ITERS, **kw)
    return out


def part_a(ep, group, sizes, device_type, out, arrays):
    from epsilon_tpu_torch.ir import ProxKind
    S, m, n = sizes["consensus"]
    world = dist.get_world_size(group)
    A, b = consensus_blocks(S, m, n)
    t0 = time.perf_counter()
    prob, z, xs = consensus_problem(ep, A, b, LAM)
    obj = prob.solve(mesh=group, warm_start=True, **TIGHT)
    _sync()
    wall = time.perf_counter() - t0
    st = prob.solver_status
    solver = cached_solver(prob)
    groups = solver.scn_groups
    bucketed = [i for bkt in (solver.buckets or []) for i in bkt]
    assert len(groups) == 1 and groups[0].S == S, \
        f"(a) expected one group of {S}, got {[(g.S, g.shared) for g in groups]}"
    g = groups[0]
    assert len(g.rows) == S // world and all(s.shape[0] == S // world for s in g.stacks)
    assert not any(solver.problem.terms[i].spec.kind == ProxKind.SUM_SQUARE
                   for i in bucketed), "(a) a SUM_SQUARE term went to a bucket"
    assert _on_device(solver, device_type), "(a) state or stacks off the device"
    out["a"] = dict(
        route="Problem.solve(mesh=group)", status=prob.status, objective=obj,
        iterations=st.num_iterations, wall_s=wall,
        setup_s=st.timing.init_usec / 1e6, solve_s=st.timing.solve_usec / 1e6,
        groups=[dict(key=g.key, S=g.S, d=g.d, rows=[g.rows.start, g.rows.stop])],
        bucketed_terms=len(bucketed), bytes=solver.operator_bytes(),
        x_digest=_digest([z.value] + [x.value for x in xs]))
    arrays["a_z"] = np.asarray(z.value, dtype=np.float64).ravel()

    def resolve(**kw):
        prob.solve(mesh=group, warm_start=True, **dict(TIGHT, **kw))
        return prob.solver_status
    out["a"]["steady"] = _steady(resolve, sizes["steady_iters"]["a"], solver,
                                 dist.get_rank(group) == 0)
    if torch.cuda.is_available():
        out["a"]["cuda_bytes_allocated"] = torch.cuda.memory_allocated()


def part_b(ep, group, sizes, device_type, out, arrays):
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    n, n_groups = sizes["hetero"]
    world = dist.get_world_size(group)
    prob = hetero_problem(n, n_groups)
    t0 = time.perf_counter()
    solver = ProxADMMTwoBlockSolver(prob, SolverParams(
        mesh=group, warm_start=True, max_iterations=20000, **SOLVE))
    x = solver.solve()
    _sync()
    wall = time.perf_counter() - t0
    covered = sorted(i for bkt in solver.buckets for i in bkt)
    assert covered == list(range(len(prob.terms))), "(b) buckets miss a term"
    assert not solver.scn_groups
    assert _on_device(solver, device_type), "(b) state off the device"
    built = [i for i, op in enumerate(solver.term_ops) if op is not None]
    assert sorted(built) == sorted(solver.buckets[dist.get_rank(group)])
    out["b"] = dict(
        status=solver.status.state.value, iterations=solver.status.num_iterations,
        wall_s=wall, setup_s=solver.status.timing.init_usec / 1e6,
        solve_s=solver.status.timing.solve_usec / 1e6,
        objective=float(solver.objective_value(x)),
        bucket_sizes=[len(bkt) for bkt in solver.buckets],
        bytes=solver.operator_bytes(), world=world,
        x_digest=_digest([x[k].cpu().numpy() for k in sorted(x.keys())]))
    arrays["b_x"] = x["x"].cpu().numpy().astype(np.float64)

    def resolve(**kw):
        solver.params = SolverParams(mesh=group, warm_start=True,
                                     **dict(SOLVE, **kw))
        solver.solve()
        return solver.status
    out["b"]["steady"] = _steady(resolve, sizes["steady_iters"]["b"], solver,
                                 dist.get_rank(group) == 0)

    # the flagship lasso: two terms on the group, the other buckets empty
    A, b, lam = workload(*sizes["flagship"])
    xv, lasso = lasso_problem(ep, A, b, lam)
    obj = lasso.solve(mesh=group, warm_start=True, **SOLVE)
    fs = cached_solver(lasso)
    assert sorted(len(bkt) for bkt in fs.buckets) == [0] * (world - 2) + [1, 1]
    out["b_flagship"] = dict(status=lasso.status, objective=obj,
                             iterations=lasso.solver_status.num_iterations,
                             bucket_sizes=[len(bkt) for bkt in fs.buckets])
    arrays["b_flagship_x"] = np.asarray(xv.value, dtype=np.float64).ravel()


def part_c(ep, group, sizes, device_type, out, arrays):
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    A, b, lam = workload(*sizes["flagship"])
    xv, lasso = lasso_problem(ep, A, b, lam)
    obj = lasso.solve(mesh=group, warm_start=True, solver="prox_admm", **SOLVE)
    solver = cached_solver(lasso)
    assert isinstance(solver, ProxADMMTwoBlockSolver) and solver.buckets is not None
    out["c_prox_admm"] = dict(status=lasso.status, objective=obj,
                              iterations=lasso.solver_status.num_iterations,
                              solver=type(solver).__name__)
    arrays["c_prox_admm_x"] = np.asarray(xv.value, dtype=np.float64).ravel()

    n, n_groups = sizes["hetero"]
    solver = ProxADMMTwoBlockSolver(hetero_problem(n, n_groups), SolverParams(
        mesh=group, adaptive_rho=True, max_iterations=20000, warm_start=True,
        **SOLVE))
    x = solver.solve()
    out["c_adaptive"] = dict(status=solver.status.state.value,
                             iterations=solver.status.num_iterations,
                             rho=float(solver._warm_state[2]),
                             objective=float(solver.objective_value(x)))
    arrays["c_adaptive_x"] = x["x"].cpu().numpy().astype(np.float64)


def part_d(ep, group, sizes, device_type, out, arrays):
    from epsilon_tpu_torch.ops.kernels import local_update as lu
    from epsilon_tpu_torch.parallel import consensus_lasso_solver
    S, m, n = sizes["consensus"]
    iters = sizes["consensus_iters"]
    A, b = consensus_blocks(S, m, n)
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, LAM, rho=RHO, group=group, rel_tol=0.0,
                                    abs_tol=0.0, max_iterations=iters,
                                    epoch_iterations=50)
    _sync()
    setup_s = time.perf_counter() - t0
    lu.launches = 0
    t0 = time.perf_counter()
    res = solver.solve()
    _sync()
    solve_s = time.perf_counter() - t0
    assert res.z.device.type == device_type
    out["d"] = dict(iterations=res.iterations, setup_s=setup_s, solve_s=solve_s,
                    ms_per_iter=1e3 * solve_s / res.iterations,
                    collectives_per_iter=solver.n_collectives / res.iterations,
                    blocks=solver.S_local, k1=solver.local_update is not None,
                    k1_launches=lu.launches, k1_shape=[solver.S_local, n],
                    k1_path=None if lu.last_plan is None else lu.last_plan.path)
    arrays["d_z"] = res.z.cpu().numpy().astype(np.float64)


def _values(z, xs):
    return np.concatenate([np.asarray(v.value, dtype=np.float64).ravel()
                           for v in [z] + xs])


def part_e(ep, group, sizes, device_type, out, arrays):
    S, m, n = sizes["wide"]
    world = dist.get_world_size(group)
    A, b = consensus_blocks(S, m, n)
    t0 = time.perf_counter()
    prob, z, xs = consensus_problem(ep, A, b, LAM, first_id=WIDE_IDS)
    obj = prob.solve(mesh=group, warm_start=True, **WIDE)
    _sync()
    wall = time.perf_counter() - t0
    st = prob.solver_status
    solver = cached_solver(prob)
    assert len(solver.scn_groups) == 1 and solver.scn_groups[0].S == S, \
        f"(e) expected one group of {S}, got {[g.S for g in solver.scn_groups]}"
    g = solver.scn_groups[0]
    assert len(g.rows) == S // world and all(s_.shape[0] == S // world for s_ in g.stacks)
    # a fresh operator of one member: the factored chain is kept
    i = g.term_idx[g.rows.start]
    op = solver._build_term_op(solver.problem, solver.problem.terms[i], solver.term_vars[i])
    assert op._collapsed is None and g.signature[0] == "kkt_chain", "(e) chain not kept"
    assert _on_device(solver, device_type), "(e) state or stacks off the device"
    out["e"] = dict(
        route="Problem.solve(mesh=group)", status=prob.status, objective=obj,
        iterations=st.num_iterations, wall_s=wall,
        setup_s=st.timing.init_usec / 1e6, solve_s=st.timing.solve_usec / 1e6,
        groups=[dict(key=g.key, S=g.S, d=g.d, rows=[g.rows.start, g.rows.stop])],
        signature=g.signature[0], chain=[[k, nk, part.sig[0]] for k, nk, part, _ in
                                         op._chain_parts(solver.term_vars[i][0])[0]],
        bucketed_terms=sum(len(bkt) for bkt in (solver.buckets or [])),
        bytes=solver.operator_bytes(), x_digest=_digest([_values(z, xs)]))
    arrays["e_x"] = _values(z, xs)

    def resolve(**kw):
        prob.solve(mesh=group, warm_start=True, **dict(WIDE, **kw))
        return prob.solver_status
    out["e"]["steady"] = _steady(resolve, sizes["steady_iters"]["e"], solver,
                                 dist.get_rank(group) == 0)
    # (g) reads the compiled problem and the variables back
    out["_e_problem"] = (prob, z, xs, solver.problem)


def loop_kernel_launches():
    """The launch counts of the hand loop kernels K6 (``sum_logistic``), K7
    (``tv1d_pdas``), K8 (``epi_exp``) and K9 (``sum_kl_div``) in this
    process."""
    from epsilon_tpu_torch.ops.kernels import epi_exp, sum_kl_div, sum_logistic, tv1d_pdas
    return {"sum_logistic_prox": sum_logistic.launches, "tv1d_pdas": tv1d_pdas.launches,
            "epi_exp": epi_exp.launches, "sum_kl_div_prox": sum_kl_div.launches}


def part_f(ep, group, sizes, device_type, out, arrays):
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    world = dist.get_world_size(group)
    out["f"] = {}
    for family in sizes["kinds"]:
        prob = kind_problem(family, sizes)
        t0 = time.perf_counter()
        solver = ProxADMMTwoBlockSolver(prob, SolverParams(
            mesh=group, max_iterations=sizes["kind_iters"][family], **KINDS))
        before = loop_kernel_launches()
        x = solver.solve()
        _sync()
        wall = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in loop_kernel_launches().items()}
        assert [g_.S for g_ in solver.scn_groups] == [sizes["kind_S"]], \
            f"(f) {family}: groups {[g_.S for g_ in solver.scn_groups]}"
        g = solver.scn_groups[0]
        st = solver._kstate0[len(solver.term_ops)] if solver._kstate0 else None
        out["f"][family] = dict(
            status=solver.status.state.value, iterations=solver.status.num_iterations,
            wall_s=wall, setup_s=solver.status.timing.init_usec / 1e6,
            ms_per_iter=solver.status.timing.solve_usec / 1e3 / solver.status.num_iterations,
            d=g.d, rows=len(g.rows), mode=[str(v) for v in g.signature[:2]],
            state_rows=None if st is None else int(st.shape[0]),
            stacked_bytes=g.stacked_bytes(), world=world, launches=launched)
        arrays[f"f_{family}_x"] = flat_x(x)


def _wide_solver(group, problem, ckpt_dir, every_epochs, **kw):
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    from epsilon_tpu_torch.utils.checkpoint import SolverCheckpointer
    solver = ProxADMMTwoBlockSolver(problem, SolverParams(
        mesh=group, drive="host", **dict(WIDE, **kw)))
    solver.attach_checkpointer(SolverCheckpointer(ckpt_dir, every_epochs=every_epochs))
    return solver


def _resumed(ep, group, problem, ckpt_dir, prob, z, xs):
    """A new solver resumes (e)'s checkpoint (and saves no more)."""
    from epsilon_tpu_torch.frontend.solve import _set_solution
    solver = _wide_solver(group, problem, ckpt_dir, every_epochs=10 ** 9)
    t0 = time.perf_counter()
    x = solver.solve()
    _sync()
    _set_solution(prob, x, problem)
    return solver, time.perf_counter() - t0, _values(z, xs)


def part_g(ep, group, sizes, device_type, out, arrays):
    prob, z, xs, problem = out.pop("_e_problem")
    ckpt_dir = os.path.join(out["out_dir"], "ckpt")
    cut = _wide_solver(group, problem, ckpt_dir, every_epochs=1,
                       max_iterations=CKPT_EPOCHS * 10)
    t0 = time.perf_counter()
    cut.solve()
    _sync()
    cut_s = time.perf_counter() - t0
    solver, resume_s, xv = _resumed(ep, group, problem, ckpt_dir, prob, z, xs)
    out["g"] = dict(cut_iterations=cut.status.num_iterations, cut_s=cut_s,
                    iterations=solver.status.num_iterations,
                    resumed_epochs=len(solver.status.series),
                    status=solver.status.state.value, resume_s=resume_s,
                    files=sorted(os.listdir(ckpt_dir)))
    arrays["g_x"] = xv


def start(rank, world, init_file, device):
    """Join the process group: ``(ep, group, backend)``."""
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.parallel import block_mesh, initialize_distributed
    config.set_device(device)
    backend = initialize_distributed(coordinator_address=f"file://{init_file}",
                                     num_processes=world, process_id=rank)
    return ep, block_mesh(), backend


def finish(group):
    dist.barrier(group)
    dist.destroy_process_group()


PARTS = (("a", part_a), ("b", part_b), ("c", part_c), ("d", part_d),
         ("e", part_e), ("f", part_f), ("g", part_g))


def run(rank, world, init_file, out_dir, device="cuda", sizes=FULL, parts=PARTS):
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.ops.kernels import sym_packed
    ep, group, backend = start(rank, world, init_file, device)
    device_type = config.device().type
    out = dict(rank=rank, world=world, backend=backend, out_dir=out_dir,
               card=(torch.cuda.current_device() if device_type == "cuda" else None))
    sym_packed.launches_by_width.clear()
    arrays = {}
    for name, part in parts:
        t0 = time.perf_counter()
        part(ep, group, sizes, device_type, out, arrays)
        out[f"{name}_seconds"] = time.perf_counter() - t0
        if rank == 0:
            print(f"[9{name}] rank 0 done in {out[f'{name}_seconds']:.1f} s", flush=True)
    # K2's launches by width of x in this rank's parts (phase 9 prints them)
    out["sym_packed_by_width"] = dict(sorted(sym_packed.launches_by_width.items()))
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=float)
    finish(group)


def run_resume(rank, world, init_file, out_dir, device="cuda", sizes=FULL):
    """(g) on ``world`` ranks: (e)'s problem, built again, resumes the
    checkpoint in ``<out_dir>/ckpt``."""
    ep, group, backend = start(rank, world, init_file, device)
    A, b = consensus_blocks(*sizes["wide"])
    prob, z, xs = consensus_problem(ep, A, b, LAM, first_id=WIDE_IDS)
    from epsilon_tpu_torch.compiler import compiler
    problem = compiler.compile_problem(prob.expression_problem())
    solver, resume_s, xv = _resumed(ep, group, problem, os.path.join(out_dir, "ckpt"),
                                    prob, z, xs)
    g = solver.scn_groups[0]
    out = dict(rank=rank, world=world, backend=backend, iterations=solver.status.num_iterations,
               resumed_epochs=len(solver.status.series), status=solver.status.state.value,
               resume_s=resume_s, rows=[g.rows.start, g.rows.stop])
    np.savez(os.path.join(out_dir, f"resume{rank}.npz"), g_x=xv)
    with open(os.path.join(out_dir, f"resume{rank}.json"), "w") as f:
        json.dump(out, f, default=float)
    finish(group)


def run_probe(rank, world, init_file, device="cuda", sizes=FULL):
    """One rank of the probe (see the module docstring); rank 0 prints."""
    from epsilon_tpu_torch import config
    ep, group, backend = start(rank, world, init_file, device)

    def say(msg):
        if rank == 0:
            print(f"[probe] world {world}, backend {backend}: {msg}", flush=True)

    # one all-reduce, as the solvers call it (blocking), median of 200
    for n in (200, 4096):
        for where in dict.fromkeys((config.device().type, "cpu")):
            t = torch.randn(n, dtype=torch.float32, device=where)
            times = []
            for k in range(220):
                _sync()
                dist.barrier(group)
                t0 = time.perf_counter()
                dist.all_reduce(t, group=group)
                _sync()
                times.append(time.perf_counter() - t0)
            say(f"all_reduce of {n} float32 on {where}: median "
                f"{1e3 * statistics.median(times[20:]):.4f} ms")

    # part (a) down a ladder of tolerances
    S, m, n = sizes["consensus"]
    A, b = consensus_blocks(S, m, n)
    if rank == 0:
        X = A.astype(np.float64).reshape(S * m, n)
        XtX, Xty = X.T @ X, X.T @ b.astype(np.float64).ravel()
        del X
    prob, z, _ = consensus_problem(ep, A, b, LAM)
    total = 0
    for tol in (1e-5, 3e-6, 1e-6, 3e-7):
        prob.solve(mesh=group, warm_start=True, **dict(TIGHT, rel_tol=tol))
        total += prob.solver_status.num_iterations
        if rank == 0:
            zv = np.asarray(z.value, dtype=np.float64).ravel()
            g = XtX @ zv - Xty
            kkt = float(np.where(zv != 0, np.abs(g + LAM * np.sign(zv)),
                                 np.maximum(np.abs(g) - LAM, 0.0)).max() / LAM)
            say(f"part (a) at rel_tol {tol:g}: {prob.status} after {total} iterations "
                f"in all, KKT/lambda {kkt:.3e}")
    finish(group)


def spawn_ranks(mode, world, timeout, out_dir=None):
    """Start ``world`` ranks of this file (``mode`` "run" or "resume" with
    ``out_dir``, or "probe-rank") and wait for them under one hard limit of ``timeout``
    seconds.  A rank that exits non-zero, or any rank still running at the
    limit (all are then killed), raises."""
    # the ranks rendezvous through a file and talk over the loopback
    # interface: the run needs no network
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the ranks share this machine's cores: the host's BLAS threads of one
    # rank must not take them all
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or world) // world)))
    with tempfile.TemporaryDirectory() as td:
        rendezvous = os.path.join(td, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank), str(world),
             rendezvous] + ([] if out_dir is None else [out_dir]), env=env)
            for rank in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a rank outlived the limit of {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")


if __name__ == "__main__":
    if sys.argv[1] == "probe":
        spawn_ranks("probe-rank", int(sys.argv[2]) if len(sys.argv) > 2 else 4, 600)
        sys.exit(0)
    mode, rank, world, rendezvous = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4])
    if mode == "probe-rank":
        run_probe(rank, world, rendezvous)
    elif mode == "resume":
        run_resume(rank, world, rendezvous, sys.argv[5])
    else:
        run(rank, world, rendezvous, sys.argv[5])
    sys.stdout.flush()
    # leave without the interpreter's teardown: the process group's threads
    # can abort it once the work is done and the results are written
    os._exit(0)
