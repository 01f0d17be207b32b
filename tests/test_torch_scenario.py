"""The port's scenario stacking over a process group
(``epsilon_tpu_torch/solvers/scenario.py``), run by 2 and by 4 gloo
processes on the CPU in float64, against the JAX package's meshed solve on
as many devices of its virtual CPU mesh and against the port in one
process: every test of ``tests/test_scenario.py``, with its 8 devices read
as 4 ranks.

One launch of ``tests/torch_mesh_worker.py`` at world 2, beside four at
world 4, runs all the cases of that size (a module-scoped fixture); each
test reads its own case.

Tolerances (``torch_mesh_launch``): the same iteration count, the residual
series to rtol 1e-6, x to atol 1e-7 / rtol 1e-5.  The stacked apply is one
batched product where one process applies term by term, and the fold sums
the scenarios in another order: no iteration count moved in these cases.
The TV-1D family (``consensus8_tv``) threads each row's warm PDAS dual,
which the JAX package's meshed solve does not (it starts PDAS cold); both
certify each prox to the inner tolerance ``prox_inner_tol_for(1e-6)`` =
1e-7, and x is held to the JAX meshed solve at that atol.
"""

import concurrent.futures
import functools
import logging

import numpy as np
import pytest

import torch_mesh_cases as mc
import torch_mesh_launch as ml
from test_solvers import _lasso_objective, lasso_oracle

TIGHT = dict(rel_tol=1e-6, abs_tol=1e-8, max_iterations=4000)
ADAPTIVE = dict(adaptive_rho=True, rel_tol=1e-5, abs_tol=1e-7,
                max_iterations=8000)


def _consensus(**kw):
    return lambda P: mc.make_consensus_lasso(P, *mc.consensus_data(), **kw)


# case -> (problem maker over an IR namespace, solver parameters)
SOLVES = {
    "scenario_device": (_consensus(), dict(TIGHT, drive="device")),
    "scenario_host": (_consensus(), dict(TIGHT, drive="host")),
    "scenario_via_y": (_consensus(via_y=True), TIGHT),
    "scenario_memory": (
        lambda P: mc.make_consensus_lasso(
            P, *mc.consensus_data(S=8, m=32, n=16)), TIGHT),
    "scenario_adaptive": (_consensus(), ADAPTIVE),
    "scenario_indivisible": (
        lambda P: mc.make_consensus_lasso(P, *mc.consensus_data(S=6)), TIGHT),
    "two_family": (
        lambda P: mc.make_consensus_lasso(P, *mc.two_family_data()), TIGHT),
    "scenario_norm2": (_consensus(kind="NORM_2"), TIGHT),
    "scenario_norm2_adaptive": (_consensus(kind="NORM_2"), ADAPTIVE),
}
# the kinds stacked since the first meshed slice, one problem each
SOLVES.update({name: ((lambda P, name=name: mc.problems(P)[name]()), params)
               for name, params in mc.KIND_SOLVES.items()})

WORLD_2 = ["scenario_device", "scenario_host", "scenario_adaptive",
           "two_family", "scenario_norm2"] + list(mc.KIND_SOLVES)
# World 4 goes in four launches of about 35 s each when run alone (four
# gloo ranks take about 12 ms an iteration here), so that a loaded machine
# stays well inside a launch's hard timeout of 120 s.
WORLD_4_LAUNCHES = [
    ["scenario_device", "scenario_host", "scenario_via_y", "mesh_flip"],
    ["scenario_memory", "scenario_update", "scenario_adaptive", "scenario_norm2",
     "scenario_norm2_adaptive"],
    ["scenario_indivisible", "two_family", "frontend_consensus", "interop_state"],
    list(mc.KIND_SOLVES),
]
WORLD_4 = [name for launch in WORLD_4_LAUNCHES for name in launch]


def _jax_interrupted_solve():
    """The JAX package's meshed consensus solve on 4 devices, cut after 100
    iterations, and gone on with from its warm state: ``(state after 100
    iterations as numpy, the solver after the second solve, its x)``."""
    import jax
    from jax.sharding import Mesh
    from epsilon_tpu.solvers import ProxADMMTwoBlockSolver, SolverParams
    mesh = Mesh(np.array(jax.devices()[:4]), ("terms",))
    prob = mc.make_consensus_lasso(mc.ns("epsilon_tpu"), *mc.consensus_data())
    js = ProxADMMTwoBlockSolver(prob, SolverParams(
        mesh=mesh, warm_start=True, **dict(TIGHT, max_iterations=100)))
    js.solve()
    z, u = js._warm_state[:2]
    state = {f"z:{k}": np.asarray(v) for k, v in z.items()}
    state.update({f"u:{k}": np.asarray(v) for k, v in u.items()})
    js.params = SolverParams(mesh=mesh, warm_start=True, **TIGHT)
    return state, js, js.solve()


@pytest.fixture(scope="module")
def jax_interrupted():
    return _jax_interrupted_solve()


@pytest.fixture(scope="module")
def ranks(jax_interrupted, tmp_path_factory):
    """``{world: the ranks' results}``: the world-2 launch runs beside the
    world-4 launches, which run one after the other (a thread waits for
    it; the ranks are processes)."""
    path = str(tmp_path_factory.mktemp("mesh") / "jax_state.npz")
    np.savez(path, **jax_interrupted[0])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world2 = pool.submit(ml.run_workers, 2, WORLD_2)
        world4 = [{} for _ in range(4)]
        for cases in WORLD_4_LAUNCHES:
            for merged, got in zip(world4, ml.run_workers(
                    4, cases, extra_env={"EPSILON_MESH_STATE": path})):
                merged.update(got)
        return {2: world2.result(), 4: world4}


def _cases():
    for world, names in ((2, WORLD_2), (4, WORLD_4)):
        for name in names:
            if name in SOLVES:
                yield pytest.param(world, name, id=f"{name}-w{world}")


def _groups(got):
    """{key: (term_idx, shared)} of the groups a worker reported."""
    return {k.split(":")[1] + ":" + k.split(":")[2]:
            ([int(i) for i in got[k]],
             str(got[k.replace("term_idx", "shared")]))
            for k in got if k.endswith(":term_idx")}


@pytest.mark.parametrize("world,case", list(_cases()))
def test_meshed_matches_jax_meshed(ranks, world, case):
    """Port over ``world`` gloo ranks == JAX package on ``world`` devices:
    the same groups, buckets, iteration count, series and x."""
    got = ml.assert_ranks_agree(ranks[world], case)
    make, params = SOLVES[case]
    js, xj = ml.jax_solve(make, world, **params)
    ml.assert_matches(got, js, xj)   # for consensus8_tv X_ATOL is PDAS's 1e-7
    assert _groups(got) == {g.key: (list(g.term_idx), g.shared)
                            for g in js.scn_groups}
    if js.buckets is None:
        assert "buckets" not in got
    else:
        assert ml.buckets_of(got, world) == js.buckets


@functools.lru_cache(maxsize=None)
def _one_process(case):
    """The port's solve of a case in this process (the same at every world
    size, so solved once)."""
    make, params = SOLVES[case]
    return ml.port_solve(make, **params)


@pytest.mark.parametrize("world,case", list(_cases()))
def test_meshed_matches_one_process(ranks, world, case):
    """Port over ``world`` gloo ranks == port in one process."""
    got = ml.assert_ranks_agree(ranks[world], case)
    ts, xt = _one_process(case)
    ml.assert_matches(got, ts, {k: v.numpy() for k, v in xt.items()})
    np.testing.assert_allclose(float(got["objective"]),
                               float(ts.objective_value(xt)), rtol=1e-9)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("drive", ["device", "host"])
def test_scenario_matches_oracle(ranks, world, drive):
    per_rank = [r[f"scenario_{drive}"] for r in ranks[world]]
    got = per_rank[0]
    assert _groups(got) == {"scn:0": (list(range(8)), "z")}
    # the norm_1 term is the only one left for bucket dispatch
    assert sorted(i for b in ml.buckets_of(got, world) for i in b) == [8]
    # rank r holds rows [r S/world, (r+1) S/world) of every stack
    per = 8 // world
    for rank, g in enumerate(per_rank):
        assert list(g["group:scn:0:rows"]) == list(range(rank * per,
                                                         (rank + 1) * per))
        assert set(g["group:scn:0:stack_rows"]) == {per}
    # stacked keys unstack to the original per-term variable names
    assert {f"x:x{i}" for i in range(8)} <= set(got)
    As, bs = mc.consensus_data()
    A_all, b_all = np.vstack(As), np.concatenate(bs)
    obj = _lasso_objective(A_all, b_all, 0.3, got["x:z"])
    obj_o = _lasso_objective(A_all, b_all, 0.3, lasso_oracle(A_all, b_all, 0.3))
    assert obj <= obj_o + 1e-3 * abs(obj_o) + 1e-5


def test_scenario_metric_weight_via_kept_constraint(ranks):
    """With an extra kept constraint z = y, the reduced projection must
    weight z by sqrt(S+1): the test against one process above would see a
    wrong weight; here, that the projection survives."""
    got = ranks[4][0]["scenario_via_y"]
    assert bool(got["has_constr_prox"])
    assert _groups(got) == {"scn:0": (list(range(8)), "z")}


def test_scenario_data_memory_is_sharded(ranks):
    """A rank holds ``S / world`` rows of every stack and of the stacked
    state, and no term operator of a stacked term."""
    per_rank = [r["scenario_memory"] for r in ranks[4]]
    d, S = 16, 8
    for g in per_rank:
        assert set(g["group:scn:0:stack_rows"]) == {S // 4}
        # the collapsed solve's S (d, d) and c (d) per row, float64
        assert int(g["stack_bytes"]) == (S // 4) * (d * d + d) * 8
        assert int(g["all_dim"]) == (S // 4) * d
        assert int(g["state_dim"]) == S * d
    # what is left in term operators is the bucket's NORM_1 term: no dense
    # data
    assert sum(int(g["term_op_bytes"]) for g in per_rank) < d * d * 8
    # every kind stacked since: 1/world of the data of the 8 members' stacks
    # (pattern arrays and LU pivots included) and of the state a rank, and
    # for TV-1D its rows of the warm duals
    from epsilon_tpu_torch.solvers.scenario import stack_tensor
    for name in NEW_KINDS:
        prob, solver = _port_ops(name)
        total = sum(stack_tensor(a).numel() * stack_tensor(a).element_size()
                    for i in range(8)
                    for a in solver.term_ops[i].stack_data(solver.term_vars[i][0]))
        d = prob.var_dims[solver.term_vars[0][0]]
        for world in (2, 4):
            for g in (r[name] for r in ranks[world]):
                assert int(g["stack_bytes"]) * world == total, name
                assert int(g["all_dim"]) * world == 8 * d
                assert int(g["state_dim"]) == 8 * d
                assert int(g["state_rows"]) == (8 // world if name == "consensus8_tv" else -1)
                assert int(g["term_op_bytes"]) < d * d * 8


def test_scenario_update_problem_keeps_layout(ranks):
    """Counterpart of ``test_scenario_update_problem_no_recompile``: the
    groups and the state layout survive ``update_problem``, only the rows
    whose data changed are stacked again (in place), and the re-solve
    serves the new data."""
    per_rank = [r["scenario_update"] for r in ranks[4]]
    got = ml.assert_ranks_agree(ranks[4], "scenario_update")
    for rank, g in enumerate(per_rank):
        assert bool(g["layout_kept"])
        # terms 0-3 kept their data; ranks 2 and 3 hold rows 4-7
        assert list(g["rebuilt"]) == ([] if rank < 2 else [2 * rank, 2 * rank + 1])
    rng2 = np.random.RandomState(7)
    As2 = [rng2.randn(12, 6) for _ in range(8)]
    x2 = rng2.randn(6) * (rng2.rand(6) < 0.5)
    bs2 = [A @ x2 + 0.05 * rng2.randn(12) for A in As2]
    As2[:4], bs2[:4] = mc.consensus_data()[0][:4], mc.consensus_data()[1][:4]
    A_all, b_all = np.vstack(As2), np.concatenate(bs2)
    obj = _lasso_objective(A_all, b_all, 0.3, got["x:z"])
    obj_o = _lasso_objective(A_all, b_all, 0.3, lasso_oracle(A_all, b_all, 0.3))
    assert obj <= obj_o + 1e-3 * abs(obj_o) + 1e-5
    ref, x_ref = ml.port_solve(
        lambda P: mc.make_consensus_lasso(P, As2, bs2), **TIGHT)
    np.testing.assert_allclose(got["x:z"], x_ref["z"].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_scenario_adaptive_rho_oracle(ranks):
    got = ranks[4][0]["scenario_adaptive"]
    assert len(_groups(got)) == 1
    As, bs = mc.consensus_data()
    A_all, b_all = np.vstack(As), np.concatenate(bs)
    obj = _lasso_objective(A_all, b_all, 0.3, got["x:z"])
    obj_o = _lasso_objective(A_all, b_all, 0.3, lasso_oracle(A_all, b_all, 0.3))
    assert obj <= obj_o + 1e-2 * abs(obj_o) + 1e-4


def test_no_stacking_when_indivisible(ranks):
    """S=6 scenarios on 4 ranks: 6 % 4 != 0, so bucket sharding."""
    got = ranks[4][0]["scenario_indivisible"]
    assert _groups(got) == {}
    assert sorted(i for b in ml.buckets_of(got, 4) for i in b) == list(range(7))
    assert np.all(np.isfinite(got["x:z"]))


@pytest.mark.parametrize("world", [2, 4])
def test_two_groups_one_shared_var_joint_fold(ranks, world):
    """Two families of different heights tied to ONE shared variable: all 8
    terms stack on it (the collapsed solves apply alike, so they merge into
    one group, as in the JAX package) with the joint weight sqrt(1 + 8)."""
    got = ranks[world][0]["two_family"]
    groups = _groups(got)
    assert {s for _, s in groups.values()} == {"z"}
    assert sum(len(t) for t, _ in groups.values()) == 8
    if world == 4:
        assert float(got["proj_w_z"]) == pytest.approx(np.sqrt(1.0 + 8.0))
    As, bs = mc.two_family_data()
    A_all, b_all = np.vstack(As), np.concatenate(bs)
    obj = _lasso_objective(A_all, b_all, 0.3, got["x:z"])
    obj_o = _lasso_objective(A_all, b_all, 0.3, lasso_oracle(A_all, b_all, 0.3))
    assert obj <= obj_o + 1e-3 * abs(obj_o) + 1e-5


def test_mesh_flip_rebuilds_cached_solver(ranks):
    """A cached warm solver given a group is rebuilt (the stacked layout
    starts cold: the same iteration count as cold), and rebuilt again when
    the group is taken away."""
    got = ml.assert_ranks_agree(ranks[4], "mesh_flip")
    assert int(got["n_groups"]) == 1 and int(got["n_groups_after"]) == 0
    assert int(got["iters"]) == int(got["iters_unmeshed"])
    assert int(got["iters_after"]) == int(got["iters_unmeshed"])


def test_problem_solve_with_group_matches_jax(ranks):
    """``Problem.solve(mesh=group)`` == the JAX package's
    ``Problem.solve(mesh=Mesh)`` on the same modeled problem; a cached warm
    solver is rebuilt in place when the group is given."""
    import jax
    from jax.sharding import Mesh
    import epsilon_tpu as ej
    got = ranks[4][0]["frontend_consensus"]
    for other in ranks[4][1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(other["frontend_consensus"][k], v)
    As, bs = mc.consensus_data()
    z = ej.Variable(6)
    xs = [ej.Variable(6) for _ in As]
    obj = 0.3 * ej.norm1(z)
    for A, b, x in zip(As, bs, xs):
        obj = obj + 0.5 * ej.sum_squares(ej._wrap(A) * x - b)
    prob = ej.Problem(ej.Minimize(obj), [x == z for x in xs])
    obj_j = prob.solve(mesh=Mesh(np.array(jax.devices()[:4]), ("terms",)), **TIGHT)
    assert str(got["status"]) == prob.status == "optimal"
    assert int(got["iters"]) == prob.solver_status.num_iterations
    np.testing.assert_allclose(got["series"],
                               ml.series_rows(prob.solver_status.series),
                               rtol=ml.SERIES_RTOL)
    np.testing.assert_allclose(float(got["objective"]), obj_j, rtol=1e-9)
    for i, v in enumerate([z] + xs):
        np.testing.assert_allclose(got[f"v{i}"], np.asarray(v.value),
                                   rtol=ml.X_RTOL, atol=ml.X_ATOL)
    assert bool(got["cached_same"])
    assert int(got["groups_before"]) == 0 and int(got["groups_after"]) == 1
    assert int(got["iters_after"]) == int(got["iters"])


def test_interop_meshed_state_from_jax(ranks, jax_interrupted):
    """The JAX package's meshed state (global layout) carried into the
    ranks' local layout and back is exact, and the port goes on from it as
    the JAX package does."""
    _, js, xj = jax_interrupted
    got = ml.assert_ranks_agree(ranks[4], "interop_state")
    for r in ranks[4]:
        assert bool(r["interop_state"]["round_trip_exact"])
        assert bool(r["interop_state"]["local_ok"])
    ml.assert_matches(got, js, xj)


# -- in one process ----------------------------------------------------------------

def test_interop_stacked_state_rows():
    """``meshed_state_from_numpy`` without a group: rank r of 4 gets rows
    ``[2r, 2r + 2)`` of a stacked key and the replicated keys whole."""
    import types
    from epsilon_tpu_torch import interop
    prob, solver = _port_ops("consensus8")
    rng = np.random.RandomState(3)
    z = {"scn:0": rng.randn(8 * 6), "z": rng.randn(6)}
    u = {"scn:0": rng.randn(8 * 6), "z": rng.randn(6)}
    parts = []
    for rank in range(4):
        groups, _, _ = _detect(prob, solver, 4, rank)
        stub = types.SimpleNamespace(
            scn_groups=groups, _kstate0=None,
            _pack_state=lambda z, u, rho, ks: (z, u) + (() if rho is None else (rho,)))
        zt, ut, rho = interop.meshed_state_from_numpy(stub, z, u, rho=2.5)
        assert float(rho) == 2.5 and rho.ndim == 0
        np.testing.assert_array_equal(zt["z"].numpy(), z["z"])
        np.testing.assert_array_equal(ut["z"].numpy(), u["z"])
        assert tuple(zt["scn:0"].shape) == (12,)
        parts.append((zt["scn:0"].numpy(), ut["scn:0"].numpy()))
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), z["scn:0"])
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), u["scn:0"])


# The problems whose families stack an operator of each kind this module
# did not stack before (the factored KKT chain, TV-1D with its warm dual,
# the epigraph, matrix, per-slice and two-argument modes, sparse and
# Kronecker blocks).  TV-1D's epigraph (``family_tv_epigraph``) is held to
# the JAX package's groups and to separate applies, not solved meshed.
NEW_KINDS = ["consensus8_wide", "consensus8_tv"] + [
    f"family_{f}" for f in mc.FAMILIES]


def _detect(prob, solver, world, rank=0):
    """``detect_scenario_groups`` as rank ``rank`` of ``world`` runs it, in
    one process: the exchange hands back every rank's share of the
    signatures, computed here from the one solver's operators."""
    from epsilon_tpu_torch.solvers import scenario
    candidates = scenario.find_candidates(prob, solver.term_vars)

    def exchange(mine):
        parts = [[solver.term_ops[ti].stack_signature(pv)
                  for ti, pv, _, _ in scenario.candidate_share(candidates, world, r)]
                 for r in range(world)]
        assert parts[rank] == mine
        return parts

    return scenario.detect_scenario_groups(prob, solver.term_ops, solver.term_vars,
                                           world, rank, exchange)


def _port_ops(name, adaptive=False):
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    config.set_device("cpu")
    prob = mc.problems(mc.ns("epsilon_tpu_torch"))[name]()
    solver = ProxADMMTwoBlockSolver(prob, SolverParams(adaptive_rho=adaptive))
    return prob, solver


# (TV-1D's epigraph at world 4 alone: the JAX package traces its bisection
# over PDAS for seconds a candidate)
@pytest.mark.parametrize("name,world,adaptive", [
    pytest.param(name, world, adaptive, id=f"{name}-{world}-{adaptive}")
    for name in ["consensus8", "consensus8_via_y", "consensus8_32_16", "consensus6",
                 "consensus12", "two_family", "hetero16"] + NEW_KINDS
    + ["family_tv_epigraph"]
    for world in ([4] if name == "family_tv_epigraph" else [2, 4, 8])
    for adaptive in (False, True)])
def test_detect_scenario_groups_equals_jax(name, world, adaptive):
    """The same groups as the JAX package on each problem of
    ``tests/test_scenario.py``: term_idx, pv_names, shared, tie_idx, S, d."""
    import jax
    from jax.sharding import Mesh
    from epsilon_tpu.solvers import ProxADMMTwoBlockSolver as JSolver
    from epsilon_tpu.solvers import SolverParams as JParams
    js = JSolver(mc.problems(mc.ns("epsilon_tpu"))[name](), JParams(
        adaptive_rho=adaptive,
        mesh=Mesh(np.array(jax.devices()[:world]), ("terms",))))
    prob, ts = _port_ops(name, adaptive)
    want = [(g.key, g.term_idx, g.pv_names, g.shared, g.tie_idx, g.S, g.d)
            for g in js.scn_groups]
    for rank in (0, world - 1):
        groups, stacked, ties = _detect(prob, ts, world, rank)
        assert [(g.key, g.term_idx, g.pv_names, g.shared, g.tie_idx, g.S, g.d)
                for g in groups] == want
        assert stacked == js._stacked_terms
        assert ties == {ci for g in js.scn_groups for ci in g.tie_idx}
        for g in groups:
            per = g.S // world
            assert list(g.rows) == list(range(rank * per, (rank + 1) * per))
            assert all(s.shape[0] == per for s in g.stacks)


def test_vacuous_zero_tie_not_folded():
    """A 0*x + (-0)*z = 0 constraint is vacuous, not an identity tie."""
    P = mc.ns("epsilon_tpu_torch")
    prob, solver = _port_ops("consensus8")
    groups, _, ties = _detect(prob, solver, 4)
    assert len({ci for g in groups for ci in g.tie_idx}) == 8
    n = prob.var_dims["z"]
    prob.constraints[0] = P.ConeConstraint(cone=P.Cone.ZERO, op=P.AffineOperator(
        P.BlockMatrix({("t0", "x0"): P.linop.scalar(0.0, n),
                       ("t0", "z"): P.linop.scalar(-0.0, n)}), P.BlockVector()))
    groups, _, ties = _detect(prob, solver, 4)
    assert 0 not in ties
    assert all(0 not in g.tie_idx for g in groups)


def test_nondivisible_scenario_count_warns(caplog):
    """No silent caps: S=12 scenarios on 8 ranks cannot stack, and the
    fallback to bucket sharding announces itself."""
    prob, solver = _port_ops("consensus12")
    with caplog.at_level(logging.INFO, logger="epsilon_tpu_torch"):
        groups, _, _ = _detect(prob, solver, 8)
    assert not groups
    assert any("falling back to bucket term sharding" in r.message
               for r in caplog.records)


def _op(kind="SUM_SQUARE", m=12, n=6, alpha=0.5, adaptive=False, rho=1.0,
        seed=0, k=None):
    """One term's operator over the variable "v", as the solver builds it."""
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    config.set_device("cpu")
    P = mc.ns("epsilon_tpu_torch")
    rng = np.random.RandomState(seed)
    if kind == "SUM_SQUARE":
        op, b = P.linop.dense(rng.randn(m, n)), rng.randn(m)
    else:
        op, b = P.linop.identity(n), rng.randn(n)
    term = P.ProxTerm(
        spec=P.ProxFunctionSpec(kind=getattr(P.ProxKind, kind), alpha=alpha, k=k),
        H=P.AffineOperator(P.BlockMatrix({(P.arg_key(0), "v"): op}),
                           P.BlockVector({P.arg_key(0): b})))
    prob = P.ProxProblem(terms=[term], constraints=[], var_dims={"v": n},
                         var_shapes={"v": (n, 1)})
    solver = ProxADMMTwoBlockSolver(
        prob, SolverParams(adaptive_rho=adaptive, rho=rho))
    return solver.term_ops[0]


SIG_BASE = dict(kind="NORM_2", n=6, alpha=0.1)


@pytest.mark.parametrize("other", [
    dict(SIG_BASE, alpha=0.2),                 # a scalar parameter
    dict(SIG_BASE, n=7),                       # a shape
    dict(SIG_BASE, kind="NORM_INF"),           # the kernel
    dict(SIG_BASE, rho=2.0),                   # the metric
    dict(kind="SUM_SQUARE", n=6, adaptive=True),   # the mode's apply path
    dict(kind="SUM_LARGEST", n=6, alpha=0.1, k=2),
    dict(kind="SUM_SQUARE", n=6),              # another apply path
], ids=["alpha", "shape", "kind", "rho", "mode", "k", "path"])
def test_signatures_differ(other):
    base = _op(**SIG_BASE).stack_signature("v")
    sig = _op(**other).stack_signature("v")
    assert base is not None and sig is not None
    assert sig != base
    hash(sig)
    if other.get("kind") == "SUM_LARGEST":
        assert sig != _op(**dict(other, k=3)).stack_signature("v")


def test_signatures_equal_on_data_alone():
    """Terms that differ in data alone (and in H's height, which the
    collapsed solve folds away) share a signature."""
    for kw in (dict(kind="NORM_2", n=6, alpha=0.1), dict(kind="SUM_SQUARE"),
               dict(kind="SUM_SQUARE", adaptive=True)):
        a = _op(seed=1, **kw).stack_signature("v")
        assert a is not None and a == _op(seed=2, **kw).stack_signature("v")
    assert (_op(m=12).stack_signature("v") == _op(m=20).stack_signature("v"))
    assert (_op(m=12, rho=2.0).stack_signature("v")
            != _op(m=12).stack_signature("v"))
    assert (_op(adaptive=True).stack_signature("v")
            != _op().stack_signature("v"))


def _members(case):
    """``(operators, private variables, d, adaptive)`` of the terms a stack
    would hold: three operators of ``_op`` (a dict of its arguments), or the
    first four private terms of a problem of ``torch_mesh_cases`` (a name,
    with ``:adaptive`` for the rho-parameterized operators)."""
    if isinstance(case, dict):
        return ([_op(seed=s, **case) for s in range(3)], ["v"] * 3,
                case.get("n", 6), bool(case.get("adaptive")))
    name, _, mode = case.partition(":")
    prob, solver = _port_ops(name, adaptive=mode == "adaptive")
    pvs = [solver.term_vars[i][0] for i in range(4)]
    return (solver.term_ops[:4], pvs, prob.var_dims[pvs[0]], mode == "adaptive")


@pytest.mark.parametrize("kw", [
    dict(kind="SUM_SQUARE"), dict(kind="SUM_SQUARE", rho=2.0),
    dict(kind="SUM_SQUARE", adaptive=True),
    dict(kind="NORM_2", alpha=0.3), dict(kind="NORM_2", alpha=0.3, rho=2.0),
    dict(kind="NORM_2", alpha=0.3, adaptive=True),
    dict(kind="NORM_1", alpha=0.3), dict(kind="NORM_INF", alpha=0.3),
    dict(kind="SUM_LARGEST", alpha=0.3, k=2), dict(kind="MAX", alpha=0.3),
    dict(kind="AFFINE", alpha=0.3, n=1, adaptive=True),
    dict(kind="AFFINE", alpha=0.3, n=1), dict(kind="TOTAL_VARIATION_1D", alpha=0.1),
] + [f"{name}:{mode}" for name in NEW_KINDS + ["family_tv_epigraph"]
       for mode in ("fixed", "adaptive")]
    + ["consensus8_wide:inverse"],
    ids=lambda kw: kw if isinstance(kw, str) else "-".join(str(v) for v in kw.values()))
def test_stacked_apply_equals_separate_applies(kw, monkeypatch):
    """The stacked apply on (S, d) inputs computes what S separate applies
    would, from the stacked data alone, threading each row's warm kernel
    state where the kernel has one (rtol 1e-12).  ``:inverse`` applies the
    chain's factors as explicit inverses, the card's solve mode."""
    import torch
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.ops.block import BlockVector
    from epsilon_tpu_torch.solvers.scenario import stack_tensor
    if isinstance(kw, str) and kw.endswith(":inverse"):
        monkeypatch.setattr(config, "FACTOR_SOLVE_MODE", "inverse")
    ops, pvs, d, adaptive = _members(kw)
    if isinstance(kw, str) and kw.endswith(":inverse"):
        assert ops[0].stack_signature(pvs[0])[2][-1][2][0] == "inverse"
    sig = ops[0].stack_signature(pvs[0])
    assert sig is not None and all(
        o.stack_signature(pv) == sig for o, pv in zip(ops, pvs))
    S = len(ops)
    V = torch.as_tensor(np.random.RandomState(9).randn(S, d))
    rho = torch.tensor(1.7, dtype=torch.float64) if adaptive else None
    data = [torch.stack([stack_tensor(a) for a in col])
            for col in zip(*[o.stack_data(pv) for o, pv in zip(ops, pvs)])]
    # the LAST operator's function over everyone's data: nothing of its own
    # data may leak into the others' rows
    fn = ops[-1].stacked_fn(pvs[-1])
    st0 = ops[-1].stacked_state_init(pvs[-1])
    if st0 is None:
        got, got_st = fn(data, V, rho), None
    else:
        got, got_st = fn(data, V, rho, torch.stack([st0] * S))
    for s, (op, pv) in enumerate(zip(ops, pvs)):
        v = BlockVector({pv: V[s]})
        if st0 is not None:
            want, want_st = op.apply_stateful(v, op.kernel_state_init(), rho=rho)
            np.testing.assert_allclose(got_st[s].numpy(), want_st.numpy(),
                                       rtol=1e-12, atol=1e-13)
        else:
            want = op.apply_rho(v, rho) if rho is not None else op.apply(v)
        np.testing.assert_allclose(got[s].numpy(), want[pv].numpy(),
                                   rtol=1e-12, atol=1e-13)


def test_unstackable_operators_answer_none():
    """TV-1D (warm kernel state) and KKT operators that kept their factored
    substitution chain went to the buckets before; now they stack: equal
    signatures on equal structure (the data aside), another signature on
    another structure (a scalar, a shape, the metric, the pivots' kinds)."""
    def sigs(**kw):
        return [_op(seed=s, **kw).stack_signature("v") for s in (1, 2)]

    tv = sigs(kind="TOTAL_VARIATION_1D", alpha=0.1)
    assert tv[0] is not None and tv[0] == tv[1]
    for other in (dict(alpha=0.2), dict(alpha=0.1, n=7), dict(alpha=0.1, rho=2.0)):
        assert _op(kind="TOTAL_VARIATION_1D", **other).stack_signature("v") != tv[0]
    affine = sigs(kind="AFFINE", alpha=0.3, n=1)
    assert _op(kind="AFFINE", alpha=0.3, n=1)._collapsed is None
    assert affine[0] is not None and affine[0] == affine[1]
    assert _op(kind="AFFINE", alpha=0.3, n=1, rho=2.0).stack_signature("v") != affine[0]
    wide = sigs(kind="SUM_SQUARE", m=4, n=40)
    assert _op(kind="SUM_SQUARE", m=4, n=40)._collapsed is None
    assert wide[0] is not None and wide[0] == wide[1]
    for other in (dict(m=5), dict(m=4, rho=2.0)):
        assert _op(kind="SUM_SQUARE", n=40, **other).stack_signature("v") != wide[0]
    # alpha scales H inside the factor: data, as in the JAX package's trace
    assert _op(kind="SUM_SQUARE", m=4, n=40, alpha=0.3).stack_signature("v") == wide[0]
    assert wide[0] != affine[0] != tv[0]
