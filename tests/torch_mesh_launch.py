"""Launch tests/torch_mesh_worker.py once per world size and keep the
results: a list of cases costs one launch, and every case is still read by
its own test.  The workers rendezvous through a file and are killed when
they outlast the hard timeout, so a hang fails the tests instead of
stalling the suite."""

import os
import subprocess
import sys
import tempfile

import numpy as np

TIMEOUT_S = 120


def run_workers(world, cases, timeout=TIMEOUT_S, extra_env=None):
    """``[{case: {name: array}} for each rank]`` of one launch."""
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "torch_mesh_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]),
               **(extra_env or {}))
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "result")
        procs = [subprocess.Popen(
            [sys.executable, worker, str(rank), str(world),
             os.path.join(td, "rendezvous"), prefix, ",".join(cases)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{o}"
        ranks = []
        for rank in range(world):
            per_case = {}
            with np.load(f"{prefix}.{rank}.npz") as data:
                for key in data.files:
                    case, name = key.split("/", 1)
                    per_case.setdefault(case, {})[name] = data[key]
            ranks.append(per_case)
        return ranks


# -- the references: the JAX package on its virtual mesh, the port in one
# -- process -------------------------------------------------------------------

# Stated tolerances of the meshed tests.  Port meshed against the JAX
# package meshed and against the port in one process: the same iteration
# count, the residual series to rtol 1e-6, x to atol 1e-7 / rtol 1e-5 (the
# JAX tests' own, tests/test_term_sharding.py:100-102).
SERIES_RTOL = 1e-6
X_ATOL, X_RTOL = 1e-7, 1e-5


def jax_solve(make, world, **params):
    """``(solver, x)`` of the JAX package's meshed two-block solve of
    ``make(P)`` on ``world`` devices of the virtual CPU mesh."""
    import jax
    from jax.sharding import Mesh
    from epsilon_tpu.solvers import ProxADMMTwoBlockSolver, SolverParams
    import torch_mesh_cases as mc
    mesh = Mesh(np.array(jax.devices()[:world]), ("terms",))
    solver = ProxADMMTwoBlockSolver(make(mc.ns("epsilon_tpu")),
                                    SolverParams(mesh=mesh, **params))
    return solver, solver.solve()


def port_solve(make, **params):
    """``(solver, x)`` of the port's two-block solve in this process."""
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    import torch_mesh_cases as mc
    config.set_device("cpu")
    solver = ProxADMMTwoBlockSolver(make(mc.ns("epsilon_tpu_torch")),
                                    SolverParams(**params))
    return solver, solver.solve()


def series_rows(series):
    return np.array([[r.r_norm, r.s_norm, r.epsilon_primal, r.epsilon_dual]
                     for r in series])


def assert_ranks_agree(ranks, case):
    """Every rank returns the same x (bitwise), iteration count and series."""
    first = ranks[0][case]
    for other in ranks[1:]:
        got = other[case]
        assert int(got["iters"]) == int(first["iters"])
        np.testing.assert_array_equal(got["series"], first["series"])
        for k in first:
            if k.startswith("x:"):
                np.testing.assert_array_equal(got[k], first[k])
    return first


def assert_matches(got, solver, x, series_rtol=SERIES_RTOL):
    """A worker's result against a reference solver (either package) after
    its solve: state, iteration count, series and every variable."""
    assert str(got["state"]) == solver.status.state.value
    assert int(got["iters"]) == solver.status.num_iterations
    np.testing.assert_allclose(got["series"], series_rows(solver.status.series),
                               rtol=series_rtol)
    keys = {k[2:] for k in got if k.startswith("x:")}
    assert keys == set(x.keys())
    for k in keys:
        np.testing.assert_allclose(got[f"x:{k}"], np.asarray(x[k]),
                                   rtol=X_RTOL, atol=X_ATOL)


def buckets_of(got, world):
    """The buckets a worker reported, as lists."""
    flat = [int(v) for v in got["buckets"]]
    cut = flat.index(-1)
    out = [[] for _ in range(world)]
    for i, j in zip(flat[:cut], flat[cut + 1:]):
        out[j].append(i)
    return out
