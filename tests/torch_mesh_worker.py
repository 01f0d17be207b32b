"""Worker process of the meshed two-block tests of the port
(tests/test_torch_term_sharding.py, tests/test_torch_scenario.py):
torch.distributed with gloo on the CPU, float64.  Loads the port alone.

Usage: python torch_mesh_worker.py <rank> <world> <init_file> <out_prefix> <case,case,...>

Runs the named cases in order (every rank the same list) and writes one
``<out_prefix>.<rank>.npz`` with the entries ``<case>/<name>``.
"""

import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import torch_mesh_cases as mc
from epsilon_tpu_torch import config
from epsilon_tpu_torch.parallel import block_mesh, initialize_distributed
from epsilon_tpu_torch.solvers import (ProxADMMSolver, ProxADMMTwoBlockSolver,
                                       SolverParams, create_solver)

P = mc.ns("epsilon_tpu_torch")
TIGHT = dict(rel_tol=1e-6, abs_tol=1e-8, max_iterations=4000)


def series(solver):
    return np.array([[r.r_norm, r.s_norm, r.epsilon_primal, r.epsilon_dual]
                     for r in solver.status.series])


def solved(solver, x, extra=None):
    """What every solving case reports."""
    out = {f"x:{k}": v.numpy() for k, v in x.items()}
    out.update(iters=solver.status.num_iterations, series=series(solver),
               state=solver.status.state.value,
               objective=float(solver.objective_value(x)))
    if solver.buckets is not None:
        out["buckets"] = np.array(
            [i for j, b in enumerate(solver.buckets) for i in b] + [-1]
            + [j for j, b in enumerate(solver.buckets) for _ in b])
    out["local_terms"] = np.array(solver.local_terms())
    for g in solver.scn_groups:
        out[f"group:{g.key}:term_idx"] = np.array(g.term_idx)
        out[f"group:{g.key}:rows"] = np.array(list(g.rows))
        out[f"group:{g.key}:stack_rows"] = np.array(
            [s.shape[0] for s in g.stacks])
        out[f"group:{g.key}:shared"] = np.array(g.shared)
    out.update(extra or {})
    return out


def solve(group, prob, **params):
    solver = ProxADMMTwoBlockSolver(prob, SolverParams(mesh=group, **params))
    x = solver.solve()
    return solver, x


# -- term buckets (tests/test_term_sharding.py) --------------------------------

def case_multi_term(group):
    return solved(*solve(group, mc.make_multi_term_problem(P), **TIGHT))


def _lasso_oracle_case(group, drive):
    A, b = mc.lasso_data(0, 30, 15)
    return solved(*solve(group, mc.make_lasso_problem(P, A, b, 0.5),
                         rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000,
                         drive=drive))


def case_lasso_device(group):
    return _lasso_oracle_case(group, "device")


def case_lasso_host(group):
    return _lasso_oracle_case(group, "host")


def case_more_ranks_than_terms(group):
    rng = np.random.RandomState(0)
    A, b = rng.randn(20, 10), rng.randn(20)
    return solved(*solve(group, mc.make_lasso_problem(P, A, b, 0.3),
                         rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000))


def case_adaptive_rho(group):
    A, b = mc.lasso_data(0, 30, 15, scale=20.0, density=0.4)
    return solved(*solve(group, mc.make_lasso_problem(P, A, b, 4.0),
                         rel_tol=1e-4, abs_tol=1e-7, max_iterations=20000,
                         adaptive_rho=True))


def case_bucket_balancing(group):
    solver = ProxADMMTwoBlockSolver(
        mc.make_multi_term_problem(P, n=16, n_groups=8),
        SolverParams(mesh=group, max_iterations=10))
    return {"sizes": np.array([len(b) for b in solver.buckets])}


def case_nblock_rewrite(group):
    prob = mc.make_multi_term_problem(P)
    common = dict(rel_tol=1e-8, abs_tol=1e-10, max_iterations=6000,
                  epoch_iterations=25)
    solver = create_solver(prob, SolverParams(solver="prox_admm", mesh=group,
                                              **common))
    assert isinstance(solver, ProxADMMTwoBlockSolver)
    try:
        ProxADMMSolver(prob, SolverParams(mesh=group))
        raised = False
    except ValueError as e:
        raised = "mesh" in str(e)
    return solved(solver, solver.solve(), {"nblock_raised": raised})


def case_bucket_memory(group):
    """Operator data on this rank's device after a solve: only the terms of
    its own bucket were built."""
    solver, x = solve(group, mc.make_hetero_16term_problem(P), **TIGHT)
    built = np.array([i for i, op in enumerate(solver.term_ops)
                      if op is not None])
    return solved(solver, x, {"built": built,
                              "bytes": np.array(solver.operator_bytes()["term_ops"])})


def case_bucket_update(group):
    """update_problem: only this rank's changed terms are rebuilt, and the
    warm re-solve lands where a fresh solve of the new data does."""
    solver, _ = solve(group, mc.make_hetero_16term_problem(P), **TIGHT)
    ops_before = list(solver.term_ops)
    solver.update_problem(mc.make_hetero_16term_problem(P, seed=7))
    kept = np.array([i for i, (a, b) in enumerate(zip(ops_before, solver.term_ops))
                     if a is b and a is not None])
    x = solver.solve()
    return solved(solver, x, {"rebuilt": np.array(solver.last_rebuilt),
                              "kept": kept})


def case_tv_warm_state(group):
    """A kernel with warm state (TV-1D) in a bucket: its owner threads the
    PDAS dual."""
    solver, x = solve(group, mc.make_multi_term_problem(P, tv=True), **TIGHT)
    tv = len(solver.problem.terms) - 1
    has = solver._kstate0 is not None and solver._kstate0[tv] is not None
    return solved(solver, x, {"threads_tv": has,
                              "owns_tv": tv in solver.local_terms()})


def case_stop_callback(group):
    """drive="host": a stop callback on the LAST rank alone stops every
    rank after the same epoch."""
    solver = ProxADMMTwoBlockSolver(
        mc.make_multi_term_problem(P),
        SolverParams(mesh=group, drive="host", rel_tol=1e-12, abs_tol=1e-14,
                     max_iterations=4000))
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] >= 3

    if dist.get_rank(group) == dist.get_world_size(group) - 1:
        solver.register_stop_callback(stop)
    x = solver.solve()
    return solved(solver, x)


def case_checkpointer_raises(group):
    solver = ProxADMMTwoBlockSolver(mc.make_multi_term_problem(P),
                                    SolverParams(mesh=group))
    try:
        solver.attach_checkpointer(object())
        raised = False
    except NotImplementedError:
        raised = True
    return {"raised": raised}


# -- scenario stacking (tests/test_scenario.py) --------------------------------

def _consensus(group, drive="device", **kw):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(), **kw)
    return solved(*solve(group, prob, drive=drive, **TIGHT))


def case_scenario_device(group):
    return _consensus(group, "device")


def case_scenario_host(group):
    return _consensus(group, "host")


def case_scenario_via_y(group):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(), via_y=True)
    solver, x = solve(group, prob, **TIGHT)
    return solved(solver, x, {"has_constr_prox": solver.constr_prox is not None})


def case_scenario_memory(group):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(S=8, m=32, n=16))
    solver, x = solve(group, prob, **TIGHT)
    g = solver.scn_groups[0]
    b = solver.operator_bytes()
    z, u = solver._warm_state[:2] if solver._warm_state else (None, None)
    return solved(solver, x, {
        "stack_bytes": np.array(b["stacks"]), "term_op_bytes": np.array(b["term_ops"]),
        "all_dim": solver.all_dims[g.key], "state_dim": solver.state_dims[g.key],
        "d": g.d, "S": g.S})


def case_scenario_update(group):
    """update_problem: the groups and the state layout survive, only the
    stacks are restacked (in place), and the re-solve serves the new data."""
    prob = mc.make_consensus_lasso(P, *mc.consensus_data())
    solver, _ = solve(group, prob, **TIGHT)
    g = solver.scn_groups[0]
    ptrs = [s.data_ptr() for s in g.stacks]
    dims = dict(solver.all_dims)
    rng2 = np.random.RandomState(7)
    As2 = [rng2.randn(12, 6) for _ in range(8)]
    x2 = rng2.randn(6) * (rng2.rand(6) < 0.5)
    bs2 = [A @ x2 + 0.05 * rng2.randn(12) for A in As2]
    # half of the terms keep their data: only the others are restacked
    As2[:4], bs2[:4] = mc.consensus_data()[0][:4], mc.consensus_data()[1][:4]
    solver.update_problem(mc.make_consensus_lasso(P, As2, bs2))
    same = (solver.scn_groups[0] is g and dims == solver.all_dims
            and ptrs == [s.data_ptr() for s in g.stacks])
    x = solver.solve()
    return solved(solver, x, {"layout_kept": same,
                              "rebuilt": np.array(solver.last_rebuilt)})


def case_scenario_adaptive(group):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data())
    return solved(*solve(group, prob, adaptive_rho=True, rel_tol=1e-5,
                         abs_tol=1e-7, max_iterations=8000))


def case_scenario_indivisible(group):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(S=6))
    return solved(*solve(group, prob, **TIGHT))


def case_two_family(group):
    prob = mc.make_consensus_lasso(P, *mc.two_family_data())
    solver, x = solve(group, prob, **TIGHT)
    return solved(solver, x, {"proj_w_z": solver._proj_w["z"]})


def case_scenario_norm2(group):
    """A stacked vector kernel: 8 private NORM_2 terms with offsets."""
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(), kind="NORM_2")
    return solved(*solve(group, prob, **TIGHT))


def case_scenario_norm2_adaptive(group):
    prob = mc.make_consensus_lasso(P, *mc.consensus_data(), kind="NORM_2")
    return solved(*solve(group, prob, adaptive_rho=True, rel_tol=1e-5,
                         abs_tol=1e-7, max_iterations=8000))


def case_mesh_flip(group):
    """One solver, warm: solved without a group, then with it (rebuilt, the
    stacked layout starts cold), then without again."""
    prob = mc.make_consensus_lasso(P, *mc.consensus_data())
    solver = ProxADMMTwoBlockSolver(prob, SolverParams(warm_start=True, **TIGHT))
    solver.solve()
    it0 = solver.status.num_iterations
    solver.params = SolverParams(warm_start=True, mesh=group, **TIGHT)
    x = solver.solve()
    out = solved(solver, x, {"iters_unmeshed": it0,
                             "n_groups": len(solver.scn_groups)})
    solver.params = SolverParams(warm_start=True, **TIGHT)
    solver.solve()
    out["n_groups_after"] = len(solver.scn_groups)
    out["iters_after"] = solver.status.num_iterations
    return out


# -- through the frontend --------------------------------------------------------

def _frontend_consensus():
    """The consensus lasso of ``mc.consensus_data`` stated with the modeling
    API: its compiled form stacks."""
    import epsilon_tpu_torch as ep
    As, bs = mc.consensus_data()
    z = ep.Variable(As[0].shape[1])
    xs = [ep.Variable(As[0].shape[1]) for _ in As]
    obj = 0.3 * ep.norm1(z)
    for A, b, x in zip(As, bs, xs):
        obj = obj + 0.5 * ep.sum_squares(ep._wrap(A) * x - b)
    return ep.Problem(ep.Minimize(obj), [x == z for x in xs]), z, xs


def _frontend_result(prob, obj, variables):
    st = prob.solver_status
    out = {f"v{i}": np.asarray(v.value) for i, v in enumerate(variables)}
    out.update(objective=obj, status=prob.status, iters=st.num_iterations,
               series=np.array([[r.r_norm, r.s_norm, r.epsilon_primal,
                                 r.epsilon_dual] for r in st.series]))
    return out


def case_frontend_consensus(group):
    """``Problem.solve(mesh=group)``; then a warm problem solved without
    and with the group: the cached solver is rebuilt for the group."""
    import importlib
    fsolve = importlib.import_module("epsilon_tpu_torch.frontend.solve")
    prob, z, xs = _frontend_consensus()
    out = _frontend_result(prob, prob.solve(mesh=group, **TIGHT), [z] + xs)
    prob2, _, _ = _frontend_consensus()
    prob2.solve(warm_start=True, **TIGHT)
    solver = fsolve._PROBLEM_CACHE[prob2][1]
    n_before = len(solver.scn_groups)
    prob2.solve(warm_start=True, mesh=group, **TIGHT)
    out.update(cached_same=fsolve._PROBLEM_CACHE[prob2][1] is solver,
               groups_before=n_before, groups_after=len(solver.scn_groups),
               iters_after=prob2.solver_status.num_iterations)
    return out


def case_frontend_prox_admm(group):
    """``Problem.solve(solver="prox_admm", mesh=group)`` on a lasso; then a
    warm problem solved by the N-block solver and given the group."""
    import epsilon_tpu_torch as ep
    A, b = mc.lasso_data(0, 30, 15)
    x = ep.Variable(15)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + 0.5 * ep.norm1(x)))
    params = dict(solver="prox_admm", rel_tol=1e-5, abs_tol=1e-7,
                  max_iterations=5000)
    out = _frontend_result(prob, prob.solve(mesh=group, **params), [x])

    # a cached N-block solver, then the group: built anew as the two-block
    # solver, and the answer is the meshed one
    import importlib
    fsolve = importlib.import_module("epsilon_tpu_torch.frontend.solve")
    x2 = ep.Variable(15)
    prob2 = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x2 - b) + 0.5 * ep.norm1(x2)))
    prob2.solve(warm_start=True, **params)
    before = fsolve._PROBLEM_CACHE[prob2][1]
    prob2.solve(warm_start=True, mesh=group, **params)
    after = fsolve._PROBLEM_CACHE[prob2][1]
    before.params = SolverParams(mesh=group, **params)
    try:
        before.solve()
        refused = False
    except ValueError:
        refused = True
    out.update(cached_before=type(before).__name__, cached_after=type(after).__name__,
               cached_after_meshed=after.mesh is group and after.buckets is not None,
               iters_flip=prob2.solver_status.num_iterations,
               v0_flip=np.asarray(x2.value), kept_solver_refuses_group=refused)
    return out


def case_interop_state(group):
    """Start from the JAX package's meshed state (global layout, written by
    the test as numpy): the round trip is exact, and the warm solve goes on
    from it."""
    from epsilon_tpu_torch import interop
    prob = mc.make_consensus_lasso(P, *mc.consensus_data())
    solver = ProxADMMTwoBlockSolver(
        prob, SolverParams(mesh=group, warm_start=True, **TIGHT))
    with np.load(os.environ["EPSILON_MESH_STATE"]) as f:
        z = {k[2:]: f[k] for k in f.files if k.startswith("z:")}
        u = {k[2:]: f[k] for k in f.files if k.startswith("u:")}
    state = interop.meshed_state_from_numpy(solver, z, u)
    g = solver.scn_groups[0]
    local_ok = tuple(state[0][g.key].shape) == (len(g.rows) * g.d,)
    z2, u2, rho = interop.meshed_state_to_numpy(solver, state)
    exact = (rho is None and set(z2) == set(z)
             and all(np.array_equal(z2[k], z[k]) for k in z)
             and all(np.array_equal(u2[k], u[k]) for k in u))
    solver._warm_state = state
    x = solver.solve()
    return solved(solver, x, {"round_trip_exact": exact, "local_ok": local_ok})


def case_dryrun(group):
    from epsilon_tpu_torch.parallel import dryrun_multichip
    out = dryrun_multichip(group)
    return {"z": out["z"].numpy(), "objective": out["objective"]}


CASES = {k[len("case_"):]: v for k, v in globals().items()
         if k.startswith("case_")}


def main():
    rank, world, init_file, out_prefix = (int(sys.argv[1]), int(sys.argv[2]),
                                          sys.argv[3], sys.argv[4])
    names = sys.argv[5].split(",")
    logging.basicConfig(level=logging.WARNING)
    torch.set_num_threads(1)
    config.set_device("cpu")
    backend = initialize_distributed(coordinator_address=f"file://{init_file}",
                                     num_processes=world, process_id=rank)
    group = block_mesh()
    assert dist.get_world_size(group) == world and backend == "gloo"
    out = {}
    for name in names:
        for k, v in CASES[name](group).items():
            out[f"{name}/{k}"] = v
    np.savez(f"{out_prefix}.{rank}.npz", **out)
    dist.barrier(group)
    dist.destroy_process_group()
    print(f"[rank {rank}] done: {len(names)} cases", flush=True)
    # Leave without the interpreter's teardown: gloo's threads can abort it
    # ("terminate called without an active exception") once the work is done
    # and the results are written.
    os._exit(0)


if __name__ == "__main__":
    main()
