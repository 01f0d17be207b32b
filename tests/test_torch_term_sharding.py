"""The port's term-sharded two-block ADMM over a process group
(``SolverParams(mesh=group)``), run by 2 and by 4 gloo processes on the
CPU in float64, against the JAX package's meshed solve on as many devices
of its virtual CPU mesh and against the port in one process: every test of
``tests/test_term_sharding.py``, with its 8 devices read as 4 ranks.

One launch of ``tests/torch_mesh_worker.py`` per world size runs all the
cases of that size (module-scoped fixtures); each test reads its own case.

Tolerances (``torch_mesh_launch``): the same iteration count, the residual
series to rtol 1e-6, x to atol 1e-7 / rtol 1e-5.  The all-reduce sums the
ranks' contributions in another order than one process, which moved no
iteration count in these cases, so the tolerances are not widened."""

import numpy as np
import pytest

import torch_mesh_cases as mc
import torch_mesh_launch as ml
from test_solvers import _lasso_objective, lasso_oracle

TIGHT = dict(rel_tol=1e-6, abs_tol=1e-8, max_iterations=4000)

# case -> (problem maker over an IR namespace, solver parameters)
SOLVES = {
    "multi_term": (lambda P: mc.make_multi_term_problem(P), TIGHT),
    "lasso_device": (
        lambda P: mc.make_lasso_problem(P, *mc.lasso_data(0, 30, 15), 0.5),
        dict(rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000, drive="device")),
    "lasso_host": (
        lambda P: mc.make_lasso_problem(P, *mc.lasso_data(0, 30, 15), 0.5),
        dict(rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000, drive="host")),
    "more_ranks_than_terms": (
        lambda P: mc.make_lasso_problem(P, *_data_20_10(), 0.3),
        dict(rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000)),
    "adaptive_rho": (
        lambda P: mc.make_lasso_problem(
            P, *mc.lasso_data(0, 30, 15, scale=20.0, density=0.4), 4.0),
        dict(rel_tol=1e-4, abs_tol=1e-7, max_iterations=20000,
             adaptive_rho=True)),
    "bucket_memory": (lambda P: mc.make_hetero_16term_problem(P), TIGHT),
    "tv_warm_state": (lambda P: mc.make_multi_term_problem(P, tv=True), TIGHT),
}


def _data_20_10():
    rng = np.random.RandomState(0)
    return rng.randn(20, 10), rng.randn(20)


WORLD_2 = ["multi_term", "lasso_device", "lasso_host", "adaptive_rho",
           "tv_warm_state", "stop_callback"]
WORLD_4 = ["multi_term", "more_ranks_than_terms", "bucket_balancing",
           "nblock_rewrite", "bucket_memory", "bucket_update",
           "checkpointer_raises", "tv_warm_state", "stop_callback",
           "frontend_prox_admm"]


@pytest.fixture(scope="module")
def world2():
    return ml.run_workers(2, WORLD_2)


@pytest.fixture(scope="module")
def world4():
    return ml.run_workers(4, WORLD_4)


@pytest.fixture
def ranks(request, world2, world4):
    return {2: world2, 4: world4}


def _cases():
    for world, names in ((2, WORLD_2), (4, WORLD_4)):
        for name in names:
            if name in SOLVES and name != "tv_warm_state":
                yield pytest.param(world, name, id=f"{name}-w{world}")


@pytest.mark.parametrize("world,case", list(_cases()))
def test_meshed_matches_jax_meshed(ranks, world, case):
    """Port over ``world`` gloo ranks == JAX package on ``world`` devices."""
    got = ml.assert_ranks_agree(ranks[world], case)
    make, params = SOLVES[case]
    js, xj = ml.jax_solve(make, world, **params)
    ml.assert_matches(got, js, xj)
    assert ml.buckets_of(got, world) == js.buckets


@pytest.mark.parametrize("world,case", list(_cases()) + [
    pytest.param(2, "tv_warm_state", id="tv_warm_state-w2"),
    pytest.param(4, "tv_warm_state", id="tv_warm_state-w4")])
def test_meshed_matches_one_process(ranks, world, case):
    """Port over ``world`` gloo ranks == port in one process."""
    got = ml.assert_ranks_agree(ranks[world], case)
    make, params = SOLVES[case]
    ts, xt = ml.port_solve(make, **params)
    ml.assert_matches(got, ts, {k: v.numpy() for k, v in xt.items()})
    np.testing.assert_allclose(float(got["objective"]),
                               float(ts.objective_value(xt)), rtol=1e-9)


@pytest.mark.parametrize("world", [2, 4])
def test_buckets_cover_every_term_once(ranks, world):
    got = ranks[world][0]["multi_term"]
    buckets = ml.buckets_of(got, world)
    assert len(buckets) == world
    assert sorted(i for b in buckets for i in b) == list(range(6))
    # every rank applies its own bucket and nothing else
    for rank, r in enumerate(ranks[world]):
        assert sorted(r["multi_term"]["local_terms"]) == sorted(buckets[rank])


@pytest.mark.parametrize("drive", ["device", "host"])
def test_sharded_lasso_oracle(ranks, drive):
    got = ranks[2][0][f"lasso_{drive}"]
    A, b = mc.lasso_data(0, 30, 15)
    obj = _lasso_objective(A, b, 0.5, got["x:x"])
    obj_o = _lasso_objective(A, b, 0.5, lasso_oracle(A, b, 0.5))
    assert obj <= obj_o + 1e-3 * abs(obj_o) + 1e-5


def test_more_ranks_than_terms_empty_buckets(ranks):
    """4 ranks, 2 terms: the empty buckets contribute zeros and still join
    the all-reduce."""
    got = ranks[4][0]["more_ranks_than_terms"]
    buckets = ml.buckets_of(got, 4)
    assert sorted(len(b) for b in buckets) == [0, 0, 1, 1]
    A, b = _data_20_10()
    obj = _lasso_objective(A, b, 0.3, got["x:x"])
    obj_o = _lasso_objective(A, b, 0.3, lasso_oracle(A, b, 0.3))
    assert obj <= obj_o + 1e-3 * abs(obj_o) + 1e-5


def test_sharded_adaptive_rho_oracle(ranks):
    got = ranks[2][0]["adaptive_rho"]
    A, b = mc.lasso_data(0, 30, 15, scale=20.0, density=0.4)
    obj = _lasso_objective(A, b, 4.0, got["x:x"])
    obj_o = _lasso_objective(A, b, 4.0, lasso_oracle(A, b, 4.0))
    assert obj <= obj_o + 1e-2 * abs(obj_o) + 1e-4


def test_bucket_balancing(ranks):
    # LPT partition: every bucket loaded when terms >> ranks
    sizes = ranks[4][0]["bucket_balancing"]["sizes"]
    assert sizes.sum() == 10 and np.all(sizes >= 1)


def test_nblock_mesh_rewrites_to_sharded_two_block(ranks):
    """solver="prox_admm" with a group is rewritten to the two-block solver
    with term sharding and lands where the sequential N-block solver does;
    ``ProxADMMSolver`` built directly with a group raises."""
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import (ProxADMMSolver, SolverParams,
                                           create_solver)
    got = ml.assert_ranks_agree(ranks[4], "nblock_rewrite")
    assert bool(got["nblock_raised"])
    assert "buckets" in got
    config.set_device("cpu")
    seq = create_solver(
        mc.make_multi_term_problem(mc.ns("epsilon_tpu_torch")),
        SolverParams(solver="prox_admm", rel_tol=1e-8, abs_tol=1e-10,
                     max_iterations=6000, epoch_iterations=25))
    assert isinstance(seq, ProxADMMSolver)
    x_seq = seq.solve()
    for k in x_seq.keys():
        np.testing.assert_allclose(got[f"x:{k}"], x_seq[k].numpy(), atol=1e-5)


def test_bucket_operators_shard_memory(ranks):
    """Counterpart of ``test_bucket_heaps_shard_memory``: a rank builds and
    uploads the operators of its own bucket only, so the bytes of operator
    data on a rank are about its bucket's share."""
    per_rank = [r["bucket_memory"] for r in ranks[4]]
    buckets = ml.buckets_of(per_rank[0], 4)
    for rank, got in enumerate(per_rank):
        assert sorted(got["built"]) == sorted(buckets[rank])
    sizes = np.array([int(g["bytes"]) for g in per_rank], dtype=float)
    assert np.all(sizes > 0)
    # balanced buckets: no rank holds more than twice an even share
    assert sizes.max() <= 2.0 * sizes.sum() / 4
    # one process holds all of it
    ts, _ = ml.port_solve(lambda P: mc.make_hetero_16term_problem(P), **TIGHT)
    total = ts.operator_bytes()["term_ops"]
    np.testing.assert_allclose(sizes.sum(), total, rtol=0.05)


def test_bucket_update_problem(ranks):
    """Counterpart of ``test_bucket_heaps_update_problem``: after
    ``update_problem`` a rank has rebuilt the changed terms of its own
    bucket and no others, and the re-solve equals a fresh solve."""
    per_rank = [r["bucket_update"] for r in ranks[4]]
    got = ml.assert_ranks_agree(ranks[4], "bucket_update")
    buckets = ml.buckets_of(got, 4)
    for rank, g in enumerate(per_rank):
        # terms 0 (NORM_1) and 15 (NORM_2) carry no data: kept as they were
        changed = sorted(set(buckets[rank]) - {0, 15})
        assert sorted(g["rebuilt"]) == changed
        assert sorted(g["kept"]) == sorted(set(buckets[rank]) & {0, 15})
    assert str(got["state"]) == "optimal"
    ref, x_ref = ml.port_solve(
        lambda P: mc.make_hetero_16term_problem(P, seed=7), **TIGHT)
    assert ref.status.state.value == "optimal"
    np.testing.assert_allclose(got["x:x"], x_ref["x"].numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_warm_kernel_state_threaded_by_owner(ranks, world):
    """The rank whose bucket holds the TV-1D term threads its PDAS dual;
    the others carry none."""
    per_rank = [r["tv_warm_state"] for r in ranks[world]]
    assert sum(bool(g["owns_tv"]) for g in per_rank) == 1
    for g in per_rank:
        assert bool(g["threads_tv"]) == bool(g["owns_tv"])


@pytest.mark.parametrize("world", [2, 4])
def test_stop_callback_on_one_rank_stops_all(ranks, world):
    """``drive="host"``: the flag of a rank-local stop callback is
    all-reduced, so every rank leaves after the same (third) epoch."""
    got = ml.assert_ranks_agree(ranks[world], "stop_callback")
    assert int(got["iters"]) == 30
    assert str(got["state"]) == "max_iterations_reached"


def test_checkpointer_with_group_raises(ranks):
    assert all(bool(r["checkpointer_raises"]["raised"]) for r in ranks[4])


def test_problem_solve_prox_admm_with_group_matches_jax(ranks):
    """``Problem.solve(solver="prox_admm", mesh=group)`` is rewritten to the
    sharded two-block solver, as the JAX package's is."""
    import jax
    from jax.sharding import Mesh
    import epsilon_tpu as ej
    got = ranks[4][0]["frontend_prox_admm"]
    A, b = mc.lasso_data(0, 30, 15)
    x = ej.Variable(15)
    prob = ej.Problem(ej.Minimize(
        0.5 * ej.sum_squares(ej._wrap(A) * x - b) + 0.5 * ej.norm1(x)))
    obj_j = prob.solve(solver="prox_admm",
                       mesh=Mesh(np.array(jax.devices()[:4]), ("terms",)),
                       rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000)
    assert str(got["status"]) == prob.status == "optimal"
    assert int(got["iters"]) == prob.solver_status.num_iterations
    np.testing.assert_allclose(got["series"],
                               ml.series_rows(prob.solver_status.series),
                               rtol=ml.SERIES_RTOL)
    np.testing.assert_allclose(float(got["objective"]), obj_j, rtol=1e-9)
    np.testing.assert_allclose(got["v0"], np.asarray(x.value),
                               rtol=ml.X_RTOL, atol=ml.X_ATOL)
    obj_o = _lasso_objective(A, b, 0.5, lasso_oracle(A, b, 0.5))
    assert float(got["objective"]) <= obj_o + 1e-3 * abs(obj_o) + 1e-5


def test_cached_nblock_solver_rebuilt_for_group(ranks):
    """``Problem.solve(solver="prox_admm", warm_start=True)`` caches the
    N-block solver; the same call with ``mesh=group`` builds the two-block
    solver over the group in its place (cold, so the answer is the meshed
    solve's own), and a kept N-block solver handed the group refuses it."""
    for r in ranks[4]:
        got = r["frontend_prox_admm"]
        assert str(got["cached_before"]) == "ProxADMMSolver"
        assert str(got["cached_after"]) == "ProxADMMTwoBlockSolver"
        assert bool(got["cached_after_meshed"])
        assert bool(got["kept_solver_refuses_group"])
        assert int(got["iters_flip"]) == int(got["iters"])
        np.testing.assert_array_equal(got["v0_flip"], got["v0"])


# -- in one process ----------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("name", ["multi_term", "multi_term_16_8",
                                  "lasso_30_15", "hetero16", "consensus6"])
def test_partition_terms_equals_jax(name, world):
    """``_partition_terms`` is pure: the same buckets as the JAX package on
    the same problem."""
    from epsilon_tpu.solvers import ProxADMMTwoBlockSolver as JSolver
    from epsilon_tpu.solvers import SolverParams as JParams
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    config.set_device("cpu")
    js = JSolver(mc.problems(mc.ns("epsilon_tpu"))[name](), JParams())
    ts = ProxADMMTwoBlockSolver(
        mc.problems(mc.ns("epsilon_tpu_torch"))[name](), SolverParams())
    assert ts._partition_terms(world) == js._partition_terms(world)
    rem = list(range(1, len(ts.problem.terms)))
    assert ts._partition_terms(world, rem) == js._partition_terms(world, rem)


def test_nblock_rejects_mesh():
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import ProxADMMSolver, SolverParams
    config.set_device("cpu")
    prob = mc.make_lasso_problem(mc.ns("epsilon_tpu_torch"),
                                 *mc.lasso_data(0, 10, 5), 0.1)
    with pytest.raises(ValueError, match="mesh"):
        ProxADMMSolver(prob, SolverParams(mesh=object()))
