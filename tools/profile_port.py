"""Device-time profile of the PyTorch/CUDA port on one GPU.

    python3 -m tools.profile_port          (from the repository root)

1. Kernel K2 alone at the slice's shape (n = 8192, R = 1, f32): device
   microseconds per call of each of its two passes, beside a dense GEMV with
   the full matrix and a plain ``tiles.sum()`` over the same packed bytes
   (a bandwidth yardstick).  Kernel K1 alone at the consensus row's shape
   (S = 200, n = 200, f32), beside its plain version (``torch.bmm`` and a
   sum) and ``Finv.sum()``.
2. The ADMM loop of the two ``chip_smoke.py`` lassos (2000 x 1000 and
   16384 x 8192) and of the consensus lasso (200 blocks of 2500 x 200,
   bench.py's consensus row): a warm re-solve for a fixed count of
   iterations without the profiler (ms/iteration), then the same re-solve
   under ``torch.profiler``.  From the profiled run alone: wall ms/iteration,
   device-busy ms/iteration (the sum of the device operations' own times;
   the loop runs on one stream, so they do not overlap), the idle share
   1 - busy / wall, device operations per iteration, and the costliest
   kernels.

    python3 -m tools.profile_port --library infinite_push,tv_1d

profiles, in place of the above, library rows (``PROBLEMS_REFERENCE``, at
their reference sizes, f32): a cold solve of 10 iterations, timed in pieces,
then a warm re-solve of 10 iterations with the same figures, plus the
host-blocking calls per iteration (``cudaStreamSynchronize`` and the copies
to and from the card).

Only events on the device are summed: an aten op's entry also carries its
kernels' device time, so summing every event counts most kernels twice.
"""

import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import workload


def device_events(prof):
    """Profiler rows of operations that ran on the device, costliest first."""
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda e: -e.self_device_time_total)


def profile_calls(tag, calls, reps=20):
    """Device time per call of each operation that each of ``calls`` runs."""
    for _, fn in calls:
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    for label, fn in calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in device_events(prof):
            print(f"[{tag}] {label}: {e.key[:60]} x{e.count}: "
                  f"{e.self_device_time_total / e.count:.2f} us per call")


def profile_kernel(sp):
    n = 8192
    rng = np.random.RandomState(1)
    M = rng.standard_normal((n, n)).astype(np.float32)
    M = M + M.T
    tiles_h, ii_h, jj_h, n_pad = sp.pack_sym_tiles(M)
    dev = torch.device("cuda")
    tiles, ii, jj = (torch.as_tensor(a, device=dev) for a in (tiles_h, ii_h, jj_h))
    plan = tuple(torch.as_tensor(a, device=dev)
                 for a in sp.sym_packed_plan(ii_h, jj_h, n_pad // sp.SYM_TILE))
    dense = torch.as_tensor(M, device=dev)
    x = torch.as_tensor(rng.standard_normal((n_pad, 1)), dtype=torch.float32, device=dev)
    profile_calls("k2", (("sym_packed_matmul", lambda: sp.sym_packed_matmul(tiles, ii, jj, x, plan)),
                         ("dense GEMV", lambda: dense @ x),
                         ("tiles.sum()", lambda: tiles.sum())))
    print(f"[k2] packed bytes {tiles.numel() * tiles.element_size()}, "
          f"dense bytes {dense.numel() * dense.element_size()}")


def profile_k1(lu):
    S, n = 200, 200
    gen = torch.Generator(device="cuda").manual_seed(2)
    Finv, Atb, u, z = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((S, n, n), (S, n), (S, n), (n,)))
    profile_calls("k1", (("fused_local_update", lambda: lu.fused_local_update(Finv, Atb, u, z, 1.0)),
                         ("plain", lambda: lu.local_update_reference(Finv, Atb, u, z, 1.0)),
                         ("Finv.sum()", lambda: Finv.sum())))
    print(f"[k1] Finv bytes {Finv.numel() * Finv.element_size()}")


def profile_steady(tag, solve, iters):
    """``solve()`` runs ``iters`` warm iterations: once untimed, once timed
    without the profiler, once under it."""
    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
    rows = device_events(prof)
    post_s = time.perf_counter() - t0
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    ops = sum(e.count for e in rows)
    print(f"{tag}: {iters} iterations without the profiler: {plain_ms / iters:.4f} ms/iter")
    print(f"{tag}: profiled: wall {wall_ms / iters:.4f} ms/iter, device busy "
          f"{busy_ms / iters:.4f} ms/iter, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{ops / iters:.1f} device operations/iter; the profiler's event processing "
          f"{post_s:.3f} s")
    for e in rows[:10]:
        print(f"{tag}:   {e.key[:60]} x{e.count}: "
              f"{e.self_device_time_total / iters:.2f} us/iter")
    host = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"):
            host[e.key] = e.count
    print(f"{tag}: host-side calls per iteration: " + ", ".join(
        f"{k} {v / iters:.1f}" for k, v in sorted(host.items())))


def profile_loop(ep, m, n, iters):
    A, b, lam = workload(m, n)
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))
    prob.solve(rel_tol=1e-3, abs_tol=1e-6, rho=1.0, warm_start=True)
    kw = dict(rel_tol=0.0, abs_tol=0.0, rho=1.0, warm_start=True,
              epoch_iterations=iters, max_iterations=iters)
    profile_steady(f"[loop] lasso {m}x{n}", lambda: prob.solve(**kw), iters)


def profile_consensus(iters):
    from epsilon_tpu_torch.parallel import consensus_lasso_solver
    from epsilon_tpu_torch.problems.scaling_bench import make_blocks
    S, m, n = 200, 2500, 200
    A, b = make_blocks(S, m, n)
    solver = consensus_lasso_solver(A, b, 0.1, rel_tol=0.0, abs_tol=0.0,
                                    max_iterations=iters, epoch_iterations=50)
    profile_steady(f"[loop] consensus {S}x{m}x{n}", solver.solve, iters)


def profile_library(rows, iters=10):
    from epsilon_tpu_torch.problems import benchmark
    for inst in benchmark.PROBLEMS_REFERENCE():
        if inst.name not in rows:
            continue
        prob = inst.create_problem()
        t0 = time.perf_counter()
        prob.solve(rel_tol=1e-3, max_iterations=iters, warm_start=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        st = prob.solver_status
        print(f"[library] {inst.name}: cold solve of {st.num_iterations} iterations: wall "
              f"{wall_s:.3f} s = solver set-up {st.timing.init_usec / 1e6:.3f} s + solve "
              f"{st.timing.solve_usec / 1e6:.3f} s + compile and write-back")
        kw = dict(rel_tol=0.0, abs_tol=0.0, warm_start=True, max_iterations=iters)
        profile_steady(f"[library] {inst.name}", lambda: prob.solve(**kw), iters)
        del prob
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device available", file=sys.stderr)
        return 1
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch.ops.kernels import local_update as lu
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if len(sys.argv) == 3 and sys.argv[1] == "--library":
        profile_library(sys.argv[2].split(","))
        return 0
    sp.build()
    lu.build()
    profile_kernel(sp)
    profile_k1(lu)
    profile_loop(ep, 2000, 1000, 200)
    profile_loop(ep, 16384, 8192, 100)
    profile_consensus(200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
