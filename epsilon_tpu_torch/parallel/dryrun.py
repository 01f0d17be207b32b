"""A short run of both sharded paths on tiny shapes.

Counterpart of ``dryrun_multichip`` of the JAX package's entry points
(``__graft_entry__.py``): every process of an initialised group calls
:func:`dryrun_multichip` together; it runs two iterations of the sharded
consensus solve and four of a term-sharded ``Problem.solve`` and checks
that what comes out is finite.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .consensus import consensus_lasso_solver

__all__ = ["dryrun_multichip"]


def dryrun_multichip(group) -> dict:
    """Returns ``{"z": the consensus iterate, "objective": the term-sharded
    solve's objective}`` (both the same on every rank)."""
    n_devices = dist.get_world_size(group)

    # 1) scenario-block sharding: consensus ADMM with all-reduced sums
    rng = np.random.RandomState(0)
    S, m, n = 2 * n_devices, 16, 8
    A = rng.randn(S, m, n).astype(np.float32)
    x0 = (rng.randn(n) * (rng.rand(n) < 0.3)).astype(np.float32)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m).astype(np.float32)
    solver = consensus_lasso_solver(A, b, lam=0.1, rho=1.0, group=group,
                                    max_iterations=2, epoch_iterations=2)
    assert solver.S_local == 2
    result = solver.solve()
    assert bool(torch.all(torch.isfinite(result.z)))

    # 2) term sharding: heterogeneous prox terms bucketed across the ranks
    # (each rank its bucket, one all-reduce of x per iteration)
    import epsilon_tpu_torch as ep

    rng = np.random.RandomState(0)
    n = 8
    A = rng.randn(16, n)
    b = rng.randn(16)
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + 0.3 * ep.norm1(x)))
    obj = prob.solve(mesh=group, max_iterations=4, epoch_iterations=2)
    assert np.isfinite(obj)
    assert prob.solver_status.num_iterations == 4
    return {"z": result.z, "objective": obj}
