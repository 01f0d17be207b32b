"""Consensus-lasso iteration rate (BASELINE config[4]).

Counterpart of ``epsilon_tpu/problems/scaling_bench.py``: ``make_blocks``
is the same numpy generator, and :func:`run_scaling` times a warm solve of
``iters`` consensus iterations, on one device or (``group``) with the
blocks split over the ranks of a process group.  The JAX package times
several mesh sizes in one process; here a process is one rank, so one run
gives one row, and the rows of runs at several world sizes are compared by
the caller.

    python -m epsilon_tpu_torch.problems.scaling_bench --nnz 1e8
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def make_blocks(S, m, n, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(S, m, n).astype(dtype) / np.sqrt(m)
    x0 = (rng.randn(n) * (rng.rand(n) < 0.1)).astype(dtype)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m).astype(dtype)
    return A, b


def run_scaling(S=32, m=500, n=500, lam=0.1, iters=500, group=None):
    """Time ``iters`` consensus iterations on the configured device, after a
    first (warm-up) solve; returns ``[{devices, iters_per_sec, efficiency}]``
    with one row.  With ``group`` (every rank calls this together) the
    blocks are split over its ranks, ``devices`` is its size and
    ``efficiency`` (the rate over a one-device run's) is left to the caller
    who has both rows: None."""
    import torch.distributed as dist

    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.parallel import consensus_lasso_solver

    A, b = make_blocks(S, m, n)
    solver = consensus_lasso_solver(
        A, b, lam, group=group, rel_tol=0.0, abs_tol=0.0,
        max_iterations=iters, epoch_iterations=min(50, iters))
    solver.solve()
    if config.on_cuda():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve()
    if config.on_cuda():
        torch.cuda.synchronize()
    ips = res.iterations / (time.perf_counter() - t0)
    devices = 1 if group is None else dist.get_world_size(group)
    return [dict(devices=devices, iters_per_sec=round(ips, 1),
                 efficiency=1.0 if group is None else None)]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--S", type=int, default=32)
    parser.add_argument("--m", type=int, default=500)
    parser.add_argument("--n", type=int, default=500)
    parser.add_argument("--nnz", type=float, default=None,
                        help="target total nonzeros; overrides m (S*m*n=nnz)")
    parser.add_argument("--iters", type=int, default=500)
    args = parser.parse_args()

    m = args.m
    if args.nnz is not None:
        m = max(int(args.nnz / (args.S * args.n)), 8)
    for r in run_scaling(S=args.S, m=m, n=args.n, iters=args.iters):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
