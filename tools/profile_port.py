"""Device-time profile of the PyTorch/CUDA port on one GPU.

    python3 -m tools.profile_port          (from the repository root)

1. Kernel K2 alone at the slice's shape (n = 8192, R = 1, f32): device
   microseconds per call of each of its two passes, beside a dense GEMV with
   the full matrix and a plain ``tiles.sum()`` over the same packed bytes
   (a bandwidth yardstick).  Kernel K1 alone at its timed shapes ((200,
   200) in f32 and f64, (40, 5000) and (8, 130) in f32): device time of
   each of its kernels beside its plain version's, and the whole call by
   CUDA events beside ``Finv.sum()``, ``torch.bmm`` and the library call
   (``--k1`` runs this part alone).
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

    python3 -m tools.profile_port --surface [trace_dir]

profiles the steady loop of the 2000 x 1000 lasso in each solver mode
(fixed rho, adaptive rho, over-relaxation 1.5, the N-block solver at rho 1
and 4) with the same figures, and writes a Chrome trace of 50 adaptive
iterations to ``<trace_dir>/trace.json`` (``utils.profile_trace``;
``build/trace_adaptive`` unless given).

    python3 -m tools.profile_port --tv1d-f64

solves the ``tv_1d`` row at its reference size twice, with float32 state
(the port's default on the card) and with float64 state on the card
(``config.default_dtype`` patched for the run; nothing in the port sets
it), and prints objective, iterations and seconds of both.

    python3 -m tools.profile_port --exit-ab max_softmax,mnist,max_gaussian

solves library rows (reference sizes, f32) with the per-row loop kernels
that stop when their state repeats and with their full-count builds put in
their place in the dispatch, in turns in this one process (exit, full,
full, exit, for several rounds): cold solves at the harness's rel_tol
(at most ``EXIT_AB_COLD_ITERS`` iterations) and warm re-solves of
``EXIT_AB_WARM_ITERS`` iterations, host wall ms/iteration of each side
(median and min-max).  Both sides compute the same bits, so they take the
same iterations; the launch counters say which kernels ran.

    python3 -m tools.profile_port --k1-tune

times K1's ring path at other sizes (rows per item, lanes per row, slabs,
blocks per SM) beside the plan's own, the streaming path and the library
call, and then ring against streaming path at small block counts, all in
one process on one card: what ``local_update_plan``'s rules were set from.

Only events on the device are summed: an aten op's entry also carries its
kernels' device time, so summing every event counts most kernels twice.
"""

import contextlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import call_ms, device_ms, interleaved_ms, workload


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


K1_SHAPES = ((200, 200, torch.float32), (200, 200, torch.float64),
             (40, 5000, torch.float32), (8, 130, torch.float32))


def profile_k1(lu):
    """K1 at each timed shape: device time of each of its kernels from the
    profiler, and CUDA-event time of the whole call beside ``Finv.sum()``,
    ``torch.bmm`` alone and the library call (bmm and the block sum)."""
    for S, n, dtype in K1_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(2)
        Finv, Atb, u, z = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                           for shape in ((S, n, n), (S, n), (S, n), (n,)))
        rhs = (Atb + z[None, :] - u).unsqueeze(-1)
        tag = f"k1 ({S}, {n}) {str(dtype)[6:]}"
        calls = (("fused_local_update", lambda: lu.fused_local_update(Finv, Atb, u, z, 1.0)),
                 ("plain", lambda: lu.local_update_reference(Finv, Atb, u, z, 1.0)),
                 ("Finv.sum()", lambda: Finv.sum()),
                 ("torch.bmm", lambda: torch.bmm(Finv, rhs)),
                 ("torch.bmm + block sum",
                  lambda: (torch.bmm(Finv, rhs).squeeze(-1) + u).sum(dim=0)))
        profile_calls(tag, calls[:2])
        print(f"[{tag}] whole call, CUDA events, median of 50: " + ", ".join(
            f"{label} {1e3 * device_ms(fn):.2f} us" for label, fn in calls)
            + f"; path {lu.plan_for(Finv, Atb, u, z).path}"
            + f"; Finv bytes {Finv.numel() * Finv.element_size()}")
        del Finv, rhs


K1_TUNE = {
    # (S, n, dtype): rows, lanes, stages, blocks per SM to try
    (200, 200, torch.float32): ((16, 32, 64), (8, 32), (2, 3, 4), (1, 2, 3)),
    (200, 200, torch.float64): ((8, 16, 32), (8, 32), (2, 3, 4), (1, 2, 3)),
    (40, 5000, torch.float32): ((2, 4), (32,), (2, 3), (1,)),
}


def tune_k1(lu):
    """Every ring plan of ``K1_TUNE`` that fits, beside the plan
    ``local_update_plan`` chooses, the streaming path and the library call,
    all in this one process on one card: each is held to the plain version,
    then timed twice (once in the list's order, once in reverse; CUDA
    events, median of 30)."""
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for (S, n, dtype), (rows_c, lanes_c, stages_c, bps_c) in K1_TUNE.items():
        gen = torch.Generator(device="cuda").manual_seed(2)
        Finv, Atb, u, z = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                           for shape in ((S, n, n), (S, n), (S, n), (n,)))
        isz = Finv.element_size()
        x_ref, xu_ref = lu.local_update_reference(Finv, Atb, u, z, 0.37)
        rhs = (Atb + 0.37 * (z[None, :] - u)).unsqueeze(-1)
        sides = {"library: torch.bmm + block sum":
                 lambda: (torch.bmm(Finv, rhs).squeeze(-1) + u).sum(dim=0)}
        plans = {"chosen": lu.plan_for(Finv, Atb, u, z),
                 "stream": lu.plan_for(Finv, Atb, u, z, aligned=False)}
        for rows in rows_c:
            for lanes in lanes_c:
                for stages in stages_c:
                    for bps in bps_c:
                        plan = lu.ring_plan(S, n, isz, sm_count, rows, lanes, stages, bps)
                        if plan.smem_bytes > min(lu.BLOCK_SMEM_LIMIT, lu.SM_SMEM_BYTES // bps
                                                 - lu.BLOCK_RESERVED_SMEM):
                            continue
                        plans[f"rows {rows} lanes {lanes} stages {stages} x{bps}"] = plan
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        for name, plan in plans.items():
            x, xu = lu._launch(plan, Finv, Atb, u, z, 0.37)
            torch.cuda.synchronize()
            if not ((x - x_ref).abs().max() <= tol * x_ref.abs().max()
                    and (xu - xu_ref).abs().max() <= tol * xu_ref.abs().max()):
                raise AssertionError(f"K1 ({S}, {n}) {dtype} {name}: wrong result")
            sides[name] = lambda plan=plan: lu._launch(plan, Finv, Atb, u, z, 0.37)
        times = {name: [] for name in sides}
        for order in (list(sides), list(sides)[::-1]):
            for name in order:
                times[name].append(1e3 * device_ms(sides[name], reps=30))
        tag = f"tune ({S}, {n}) {str(dtype)[6:]}"
        for name in sorted(times, key=lambda k: min(times[k])):
            plan = plans.get(name)
            print(f"[{tag}] {name}: {times[name][0]:.2f}, {times[name][1]:.2f} us"
                  + (f"  (grid {plan.grid}, {plan.smem_bytes} B)" if plan else ""))
        del Finv, rhs, sides, plans


def crossover_k1(lu):
    """Ring against streaming path where the items are few: n = 200 (and the
    ragged 130 in f64) at rising block counts, both through the private
    launcher, in turns (``chip_smoke.interleaved_ms``)."""
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for S, n in ((8, 130), (5, 200), (20, 200), (40, 200), (75, 200), (100, 200), (151, 200)):
            isz = torch.empty((), dtype=dtype).element_size()
            if (n * isz) % 16:
                continue
            gen = torch.Generator(device="cuda").manual_seed(2)
            Finv, Atb, u, z = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                               for shape in ((S, n, n), (S, n), (S, n), (n,)))
            stream = lu.plan_for(Finv, Atb, u, z, aligned=False)
            ring = lu.ring_plan(S, n, isz, sm_count, 32, 8, 3 if isz == 4 else 2, 2)
            ab = interleaved_ms({
                "ring": lambda: lu._launch(ring, Finv, Atb, u, z, 0.37),
                "stream": lambda: lu._launch(stream, Finv, Atb, u, z, 0.37)})
            print(f"[crossover ({S}, {n}) {str(dtype)[6:]}] {ring.items} items, ring grid "
                  f"{ring.grid}; plan's path {lu.plan_for(Finv, Atb, u, z).path}; " + "; ".join(
                      f"{k} {1e3 * m:.2f} ({1e3 * lo:.2f}-{1e3 * hi:.2f}) us"
                      for k, (m, lo, hi) in ab.items())
                  + f"; back-to-back per call: ring "
                  f"{1e3 * call_ms(lambda: lu._launch(ring, Finv, Atb, u, z, 0.37)):.2f} us, stream "
                  f"{1e3 * call_ms(lambda: lu._launch(stream, Finv, Atb, u, z, 0.37)):.2f} us")


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
    for e in sorted(rows, key=lambda e: -e.count)[:12]:
        print(f"{tag}:   by count: {e.key[:60]} {e.count / iters:.1f}/iter")
    host = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"):
            host[e.key] = e.count
    print(f"{tag}: host-side calls per iteration: " + ", ".join(
        f"{k} {v / iters:.1f}" for k, v in sorted(host.items())))


def profile_loop(ep, m, n, iters, tag="", **params):
    A, b, lam = workload(m, n)
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))
    params = dict(dict(rho=1.0, warm_start=True), **params)
    prob.solve(rel_tol=1e-3, abs_tol=1e-6, **params)
    kw = dict(params, rel_tol=0.0, abs_tol=0.0, epoch_iterations=iters,
              max_iterations=iters)
    profile_steady(f"[loop] lasso {m}x{n}{tag}", lambda: prob.solve(**kw), iters)
    return prob, kw


def profile_surface(ep, trace_dir="build/trace_adaptive"):
    """The flagship's steady loop in every solver mode, and a trace."""
    from epsilon_tpu_torch.utils import profile_trace
    for tag, params in ((" fixed rho", {}), (" adaptive rho", dict(adaptive_rho=True)),
                        (" over-relaxation 1.5", dict(over_relaxation=1.5)),
                        (" N-block rho 1", dict(solver="prox_admm")),
                        (" N-block rho 4", dict(solver="prox_admm", rho=4.0))):
        prob, kw = profile_loop(ep, 2000, 1000, 200, tag=tag, **params)
        if "adaptive_rho" in params:
            with profile_trace(trace_dir) as prof:
                prob.solve(**dict(kw, max_iterations=50, epoch_iterations=10))
            busy = sum(e.self_device_time_total for e in device_events(prof))
            print(f"[surface] trace of 50 adaptive iterations written to "
                  f"{trace_dir}/trace.json; device busy {busy / 1e3:.3f} ms")


def profile_tv1d_f64():
    """tv_1d at reference size with f32 and with f64 state on the card."""
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.problems import benchmark
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == "tv_1d")
    real = config.default_dtype, config.default_np_dtype
    for name, dt, npdt in (("f32", torch.float32, np.float32), ("f64", torch.float64, np.float64)):
        config.default_dtype, config.default_np_dtype = (lambda dt=dt: dt), (lambda d=npdt: np.dtype(d))
        try:
            for rel_tol in (1e-3, 1e-5):
                row = benchmark.benchmark_epsilon(inst, rel_tol=rel_tol, max_iterations=50000)
                print(f"[tv1d] {name} state, rel_tol {rel_tol:g}: objective {row['objective']:.9g}, "
                      f"{row['iterations']} iterations ({row['status']}), set-up "
                      f"{row['setup_s']:.3f} s, solve {row['solve_s']:.3f} s, "
                      f"{row['ms_per_iter']:.4f} ms/iter")
        finally:
            config.default_dtype, config.default_np_dtype = real


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


EXIT_AB_COLD_ITERS = 1000
EXIT_AB_WARM_ITERS = 100
EXIT_AB_ROUNDS = 3


@contextlib.contextmanager
def full_count_entries():
    """The dispatch of ``ops/prox`` sends K3 and K5's calls to their
    full-count builds while the context is open."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, lse_rows
    swaps = [(lse_rows, "prox_rows", lse_rows.prox_rows_full),
             (lse_rows, "epi_rows", lse_rows.epi_rows_full),
             (epi_neg_log, "epi_rows", epi_neg_log.epi_rows_full)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, full in swaps:
        setattr(mod, name, full)
    try:
        yield
    finally:
        for (mod, name, _), entry in zip(swaps, saved):
            setattr(mod, name, entry)


def exit_ab(rows, rounds=EXIT_AB_ROUNDS):
    """Library rows with the kernels that exit against their full-count
    builds, in turns: cold solves, then warm re-solves."""
    from chip_smoke import LIBRARY_REL_TOL, row_launches
    from epsilon_tpu_torch.problems import benchmark
    sides = {"exit": contextlib.nullcontext, "full": full_count_entries}
    for inst in benchmark.PROBLEMS_REFERENCE():
        if inst.name not in rows:
            continue
        warm = dict(rel_tol=0.0, abs_tol=0.0, warm_start=True, max_iterations=EXIT_AB_WARM_ITERS)
        prob = inst.create_problem()
        prob.solve(rel_tol=LIBRARY_REL_TOL, max_iterations=EXIT_AB_WARM_ITERS, warm_start=True)
        cold, hot, runs, launched = {s: [] for s in sides}, {s: [] for s in sides}, {}, {}
        for _ in range(rounds):
            for side in list(sides) + list(sides)[::-1]:
                before = sum(row_launches().values())
                with sides[side]():
                    row = benchmark.benchmark_epsilon(inst, rel_tol=LIBRARY_REL_TOL,
                                                      max_iterations=EXIT_AB_COLD_ITERS)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prob.solve(**warm)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                launched[side] = launched.get(side, 0) + sum(row_launches().values()) - before
                cold[side].append(row["ms_per_iter"])
                hot[side].append(1e3 * wall / prob.solver_status.num_iterations)
                runs.setdefault(side, set()).add((row["iterations"], row["status"],
                                                  row["objective"]))
        if launched["full"] != 0 or launched["exit"] == 0:
            raise AssertionError(f"{inst.name}: kernel launches {launched}")
        iters = sorted({it for side in sides for it, _, _ in runs[side]})
        parts = []
        for label, r in ((f"cold, {'/'.join(map(str, iters))} iterations", cold),
                         (f"warm, {EXIT_AB_WARM_ITERS} iterations", hot)):
            m = {side: statistics.median(r[side]) for side in sides}
            parts.append(f"{label}: exit {m['exit']:.4f} ms/iter ({min(r['exit']):.4f}-"
                         f"{max(r['exit']):.4f}), full {m['full']:.4f} ({min(r['full']):.4f}-"
                         f"{max(r['full']):.4f}), ratio {m['exit'] / m['full']:.3f}")
        print(f"[exit-ab] {inst.name} in turns ({rounds} rounds of exit, full, full, exit): "
              + "; ".join(parts) + f"; kernel launches {launched}; the cold solves "
              + "; ".join(f"{side} " + ", ".join(f"{it} iterations {st} objective {obj!r}"
                                               for it, st, obj in sorted(runs[side]))
                          for side in sides))
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
    if sys.argv[1:2] == ["--surface"] and len(sys.argv) <= 3:
        profile_surface(ep, *sys.argv[2:])
        return 0
    if sys.argv[1:] == ["--tv1d-f64"]:
        profile_tv1d_f64()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--exit-ab":
        exit_ab(sys.argv[2].split(","))
        return 0
    if sys.argv[1:] == ["--k1"]:
        lu.build()
        profile_k1(lu)
        return 0
    if sys.argv[1:] == ["--k1-tune"]:
        tune_k1(lu)
        crossover_k1(lu)
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
