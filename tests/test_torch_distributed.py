"""The port's consensus lasso across two processes (torch.distributed with
gloo on the CPU): every rank holds 4 of the 8 blocks, and the result must
match the port on one process and the JAX package on its 8-device CPU mesh.

Tolerances: z atol 1e-6 and iterations within one epoch (25) of either
reference, as tests/test_distributed.py allows the JAX package (the
all-reduce sums in another order than one process).  The workers rendezvous
through a file, so no port can race, and are killed if they outlast a hard
timeout, so a hang fails the test instead of stalling the suite.  The run
takes a few seconds."""

import os
import subprocess
import sys
import tempfile

import numpy as np

from epsilon_tpu.parallel import block_mesh as jblock_mesh
from epsilon_tpu.parallel import consensus_lasso_solver as jsolver
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.parallel import consensus_lasso_solver as tsolver

WORLD = 2
TIMEOUT_S = 120


def _run_workers():
    worker = os.path.join(os.path.dirname(__file__), "torch_distributed_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "result")
        procs = [subprocess.Popen(
            [sys.executable, worker, str(rank), str(WORLD), os.path.join(td, "rendezvous"),
             prefix], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(WORLD)]
        try:
            outs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{o}"
        return [dict(np.load(f"{prefix}.{rank}.npz")) for rank in range(WORLD)]


def test_two_process_consensus_matches_single():
    got = _run_workers()
    # z and rho are replicated: both ranks end on the same iterate
    np.testing.assert_array_equal(got[0]["z"], got[1]["z"])
    assert got[0]["iterations"] == got[1]["iterations"]
    for g in got:
        assert bool(g["converged"])
        assert bool(g["uneven_raised"])      # S % world_size != 0

    S, m, n, lam = 8, 60, 40, 0.4
    rng = np.random.RandomState(0)
    A = rng.randn(S, m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.2)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)
    kw = dict(rel_tol=1e-6, abs_tol=1e-9, max_iterations=2000, epoch_iterations=25)
    tconfig.set_device("cpu")
    single = tsolver(A, b, lam, **kw).solve()
    mesh = jblock_mesh()
    assert mesh.devices.size == 8
    jax_mesh = jsolver(A, b, lam, mesh=mesh, **kw).solve()
    for ref in (single, jax_mesh):
        assert abs(int(got[0]["iterations"]) - ref.iterations) <= 25
        np.testing.assert_allclose(got[0]["z"], np.asarray(ref.z), atol=1e-6)
