"""Worker process for the two-process consensus test of the port
(tests/test_torch_distributed.py): torch.distributed with gloo on the CPU.
Imports no JAX.

Usage: python torch_distributed_worker.py <rank> <world> <init_file> <out_prefix>
"""

import os
import sys

import numpy as np
import torch.distributed as dist

from epsilon_tpu_torch import config
from epsilon_tpu_torch.parallel import (block_mesh, consensus_lasso_solver,
                                        initialize_distributed)

rank, world, init_file, out_prefix = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
config.set_device("cpu")
initialize_distributed(coordinator_address=f"file://{init_file}",
                       num_processes=world, process_id=rank)
group = block_mesh()
assert dist.get_world_size(group) == world and dist.get_backend(group) == "gloo"

# the data of tests/distributed_worker.py
S, m, n, lam = 8, 60, 40, 0.4
rng = np.random.RandomState(0)
A = rng.randn(S, m, n) / np.sqrt(m)
x0 = rng.randn(n) * (rng.rand(n) < 0.2)
b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)

solver = consensus_lasso_solver(A, b, lam, group=group, rel_tol=1e-6,
                                abs_tol=1e-9, max_iterations=2000,
                                epoch_iterations=25)
assert solver.S_local == S // world
res = solver.solve()

try:
    consensus_lasso_solver(A[:S - 1], b[:S - 1], lam, group=group)
    uneven_raised = False
except ValueError:
    uneven_raised = True

np.savez(f"{out_prefix}.{rank}.npz", z=res.z.numpy(), iterations=res.iterations,
         converged=res.converged, series=res.series, uneven_raised=uneven_raised)
dist.barrier(group)
dist.destroy_process_group()
print(f"[rank {rank}] done: iters={res.iterations} r={res.r_norm:.2e}", flush=True)
# Leave without the interpreter's teardown: gloo's threads can abort it
# ("terminate called without an active exception") once the work is done
# and the results are written.
os._exit(0)
