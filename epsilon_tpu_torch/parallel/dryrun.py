"""Counterparts of the JAX package's entry points (``__graft_entry__.py``)
on tiny shapes.

- :func:`entry` — one epoch of the consensus lasso as a pure function of
  ``(data, state)``, with its example arguments.
- :func:`dryrun_multichip` — every process of an initialised group calls
  it together; it runs two iterations of the sharded consensus solve and
  four of a term-sharded ``Problem.solve`` and checks that what comes out
  is finite.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .consensus import consensus_lasso_solver

__all__ = ["entry", "dryrun_multichip"]


def _consensus_data(S: int, m: int, n: int):
    """The entry points' consensus lasso data (seed 0, float32), drawn as
    ``__graft_entry__._make_solver`` draws it."""
    rng = np.random.RandomState(0)
    A = rng.randn(S, m, n).astype(np.float32)
    x0 = (rng.randn(n) * (rng.rand(n) < 0.3)).astype(np.float32)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m).astype(np.float32)
    return A, b


def entry():
    """``(fn, example_args)``: ``fn(data, state)`` is one epoch of the
    consensus lasso (S=4 blocks of 32 x 16, lam 0.1, rho 1) on the
    configured device, a pure function of its arguments with no host sync
    inside (:meth:`ConsensusADMM.epoch_step`); ``example_args`` are the
    solver's data and its initial state."""
    solver = consensus_lasso_solver(*_consensus_data(4, 32, 16), lam=0.1, rho=1.0)

    def step(data, state):
        return solver.epoch_step(data, state)

    return step, (solver.data, solver.init_state())


def dryrun_multichip(group) -> dict:
    """Returns ``{"z": the consensus iterate, "objective": the term-sharded
    solve's objective}`` (both the same on every rank)."""
    n_devices = dist.get_world_size(group)

    # 1) scenario-block sharding: consensus ADMM with all-reduced sums
    A, b = _consensus_data(2 * n_devices, 16, 8)
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
