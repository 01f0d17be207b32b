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

    python3 -m tools.profile_port --exit-ab oneclass_svm,mnist,tv_1d@n_block,family:tv

solves specs (library rows at reference size, f32, ``row`` or ``row@set``
as for ``--plain-ab`` below, or ``family:<kind>``) with the redesigned
kernels and with the builds each replaced put in their place in the
dispatch (K3's prox one row a warp; K3's epigraph, K4 and K5 their
full-count builds; K7 its levels build), in turns in this one process
(kernel, replaced, replaced, kernel, for several rounds): cold solves at
the harness's rel_tol (at most ``EXIT_AB_COLD_ITERS`` iterations) and, for
a library row, warm re-solves of ``EXIT_AB_WARM_ITERS`` iterations, host
wall ms/iteration of each side (median and min-max).  Both sides compute
the same bits, so they take the same iterations; the launch counters say
which kernels ran.

    python3 -m tools.profile_port --k7-tiles [n ...] [--earlier <tree>]

times K7's tile build at every depth K = 6..11 that fits, each with its
residue stage where that fits and with levels K..steps-2 in device memory,
and its levels build, in turns, at n = 10,000, 100,000 and 1,000,000 (or
the n given), f32 and f64, cold and warm: what ``tile_plan``'s K and its
residue rule were set from; with ``--earlier``, the tile build of an
earlier tree (say a ``git archive`` of the parent commit, whose build has
no residue stage) beside them.

    python3 -m tools.profile_port --plain-ab logreg_l1,tv_1d@n_block,family:tv

solves library rows (``row``, or ``row@set`` under a parameter set of
``tests/data/library_reference.json``) at their reference sizes, or phase 9
(f)'s family of a kind in one process (``family:tv``, ``family:two_arg``),
or one ``eval_prox`` call of a frontend kind at phase 8 (g)'s 10^6
elements (``eval_prox:sum_exp``, ``eval_prox:sum_neg_entr``,
``eval_prox:sum_inv_pos``), with the hand kernels K6 (SUM_LOGISTIC prox),
K7 (TV-1D PDAS), K8 (EXP epigraph), K9 (SUM_KL_DIV prox), K10 (SUM_INV_POS
prox) and K11 (SUM_EXP and SUM_NEG_ENTR proxes) and with their plain
versions put in their place in the dispatch, in turns in this one process
(kernel, plain, plain, kernel): ms and device operations an iteration of
each side (the cold solve at the harness's rel_tol; the operations from a
profiled warm re-solve of 10 iterations, a family's from a profiled solve;
an ``eval_prox`` call's ms and operations counted as one iteration),
iterations and objectives, and the kernels' launches.

    python3 -m tools.profile_port --k6 [side,side,...]
    python3 -m tools.profile_port --k10 [side,side,...]
    python3 -m tools.profile_port --k9 [side,side,...]

measure one of the one-thread-an-element loop kernels at phase 7a's
inputs, lam a number: K6 (``csrc/sum_logistic.cu``, the SUM_LOGISTIC prox)
at 1,500 elements (``logreg_l1``'s) and 100,000, f32 and f64; K10
(``csrc/sum_inv_pos.cu``, the SUM_INV_POS prox) at 10^6 elements in f32
and f64 and at 10,000 in f32; K9 (``csrc/sum_kl_div.cu``, the SUM_KL_DIV
prox) at 10,000 in f32 and f64 and at 100,000 in f32.  For each side:
its registers (``ptxas``) and the resident warps they allow at 256
threads a block; the instructions of each kernel and of its loop bodies
and the IEEE divisions that call a slow path (``cuobjdump -sass``;
listings under ``build/k6_sass/`` and so on); element 0's cycles a Newton
step and a widening step of the dispatched and the full-count build, at
1,500 elements (K6) or 10^6 (K10), f32 and f64, from ``clock64`` marks
where the side's source has them (built with ``-DK6_STEP_MARKS`` or
``-DK10_STEP_MARKS``; K9 has none).  Then every side's kernel timed in
turns (``interleaved_ms``) with this tree's full-count build and the
measured chains (``chip_smoke.k6_chain``, ``element_chain``), each held
bitwise to the full-count build, beside the launch floor.  A side is
``this`` (this tree, the default) or the root of a checkout (its source
with the same C entries, say the parent unpacked by ``git archive`` under
``build/``), with nvcc flags after ``@`` (``tree@-DNAME=1``: a ``-D`` that
the side's source reads).  Prints a line a case and a JSON line.

    python3 -m tools.profile_port --k2 tree[,tree,...]

times this tree's K2 (``csrc/sym_packed.cu``) in turns with the K2 of
each other checkout (its ``csrc/sym_packed.cu`` with the same C entries,
say the parent unpacked by ``git archive`` under ``build/``) at n = 8192,
every width of ``chip_smoke.K2_WIDTHS`` above 1, f32 and f64, and says
whether every side's result is bitwise equal to this tree's.

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
        t = st.timing
        print(f"[library] {inst.name}: cold solve of {st.num_iterations} iterations: wall "
              f"{wall_s:.3f} s; compile {t.compile_usec / 1e6:.3f} s, rebuild "
              f"{t.update_usec / 1e6:.3f} s, solver set-up {t.init_usec / 1e6:.3f} s, solve "
              f"{t.solve_usec / 1e6:.3f} s, write-back {t.writeback_usec / 1e6:.3f} s")
        kw = dict(rel_tol=0.0, abs_tol=0.0, warm_start=True, max_iterations=iters)
        profile_steady(f"[library] {inst.name}", lambda: prob.solve(**kw), iters)
        del prob
        torch.cuda.empty_cache()


EXIT_AB_COLD_ITERS = 1000
EXIT_AB_WARM_ITERS = 100
EXIT_AB_ROUNDS = 3


@contextlib.contextmanager
def replaced_entries():
    """The dispatch of ``ops/prox`` sends each redesigned kernel's calls to
    the build it replaced while the context is open: K3's prox to one row a
    warp, K3's epigraph, K4 and K5 to their full-count builds, K7 to its
    levels build (a grid sync after every PCR level and every pass)."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, epi_sum_square, lse_rows, tv1d_pdas
    swaps = [(lse_rows, "prox_rows", lse_rows.prox_rows_wide),
             (lse_rows, "epi_rows", lse_rows.epi_rows_full),
             (epi_sum_square, "epi_rows", epi_sum_square.epi_rows_full),
             (epi_neg_log, "epi_rows", epi_neg_log.epi_rows_full),
             (tv1d_pdas, "pdas", tv1d_pdas.pdas_levels)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, full in swaps:
        setattr(mod, name, full)
    try:
        yield
    finally:
        for (mod, name, _), entry in zip(swaps, saved):
            setattr(mod, name, entry)


def _spec_solves(spec, refs, cap=None, profile_iters=None, warm=True):
    """The solves of a spec: a library row at its reference size (``row``,
    or ``row@set`` under a parameter set of ``library_reference.json``),
    ``family:<kind>``, phase 9 (f)'s family in one process, or
    ``eval_prox:<kind>``, one ``eval_prox`` call (``_eval_prox_solve``).  Returns
    ``(cold, warm)``: ``cold()`` solves it cold at the harness's rel_tol and
    the reference's iteration cap (at most ``cap``), with a profiled warm
    re-solve of ``profile_iters`` iterations where given, and returns the
    row's figures (``ms_per_iter``, ``iterations``, ...); with ``warm``,
    ``warm(iters)`` re-solves one problem (set up and solved here first)
    warm for ``iters`` iterations and returns the host wall ms an iteration
    (None for a family or an ``eval_prox`` call, or without ``warm``)."""
    from chip_smoke import LIBRARY_REL_TOL
    from epsilon_tpu_torch.problems import benchmark
    if spec.startswith("family:"):
        return (lambda: _family_solve(spec.split(":", 1)[1])), None
    if spec.startswith("eval_prox:"):
        return (lambda: _eval_prox_solve(spec.split(":", 1)[1])), None
    name, _, pset = spec.partition("@")
    ref_set = refs[pset] if pset else refs
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == name)
    params = ref_set.get("params", {}) if pset else {}
    limit = ref_set["rows"][name]["max_iterations"]
    limit = limit if cap is None else min(limit, cap)
    extra = {} if profile_iters is None else {"profile_iters": profile_iters}

    def cold():
        return benchmark.benchmark_epsilon(inst, rel_tol=LIBRARY_REL_TOL, max_iterations=limit,
                                           **extra, **params)
    if not warm:
        return cold, None
    prob = inst.create_problem()
    prob.solve(rel_tol=LIBRARY_REL_TOL, max_iterations=EXIT_AB_WARM_ITERS, warm_start=True,
               **params)

    def resolve(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob.solve(rel_tol=0.0, abs_tol=0.0, warm_start=True, max_iterations=iters, **params)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / prob.solver_status.num_iterations
    return cold, resolve


def exit_ab(specs, rounds=EXIT_AB_ROUNDS):
    """Specs (``_spec_solves``) with the redesigned kernels against the
    builds they replaced, in turns: cold solves, then warm re-solves (a
    library row's)."""
    import json
    from chip_smoke import REFERENCE_JSON, row_launches
    refs = json.loads(REFERENCE_JSON.read_text())
    sides = {"kernel": contextlib.nullcontext, "replaced": replaced_entries}
    for spec in specs:
        cold_solve, warm_solve = _spec_solves(spec, refs, cap=EXIT_AB_COLD_ITERS)
        cold, hot, runs, launched = {s: [] for s in sides}, {s: [] for s in sides}, {}, {}
        for _ in range(rounds):
            for side in list(sides) + list(sides)[::-1]:
                before = sum(row_launches().values())
                with sides[side]():
                    row = cold_solve()
                    if warm_solve is not None:
                        hot[side].append(warm_solve(EXIT_AB_WARM_ITERS))
                launched[side] = launched.get(side, 0) + sum(row_launches().values()) - before
                cold[side].append(row["ms_per_iter"])
                runs.setdefault(side, set()).add((row["iterations"], row["status"],
                                                  row.get("objective")))
        if launched["replaced"] != 0 or launched["kernel"] == 0:
            raise AssertionError(f"{spec}: kernel launches {launched}")
        iters = sorted({it for side in sides for it, _, _ in runs[side]})
        parts = []
        for label, r in ((f"cold, {'/'.join(map(str, iters))} iterations", cold),
                         (f"warm, {EXIT_AB_WARM_ITERS} iterations", hot)):
            if not r["kernel"]:
                continue
            m = {side: statistics.median(r[side]) for side in sides}
            parts.append(f"{label}: kernel {m['kernel']:.4f} ms/iter ({min(r['kernel']):.4f}-"
                         f"{max(r['kernel']):.4f}), replaced {m['replaced']:.4f} "
                         f"({min(r['replaced']):.4f}-{max(r['replaced']):.4f}), ratio "
                         f"{m['kernel'] / m['replaced']:.3f}")
        print(f"[exit-ab] {spec} in turns ({rounds} rounds of kernel, replaced, replaced, "
              f"kernel): "
              + "; ".join(parts) + f"; kernel launches {launched}; the cold solves "
              + "; ".join(f"{side} " + ", ".join(f"{it} iterations {st} objective {obj!r}"
                                               for it, st, obj in sorted(runs[side]))
                          for side in sides), flush=True)
        torch.cuda.empty_cache()


K7_SWEEP_LEVELS = tuple(range(6, 12))
K7_SWEEP_ROUNDS, K7_SWEEP_REPS = 3, 20


# The C entry of an earlier tree's tile build, which has no residue stage:
# no group in its arguments, and a byte of act a row.
K7_EARLIER_ARGS = ("P", "P", "P", "scalar", "scalar", "I", "I", "I", "I", "I", "I", "P", "P",
                   "P", "P", "P", "P", "P", "P", "I", "P")


def _k7_earlier(tree):
    """A launcher of the tile build of an earlier tree (``csrc/tv1d_pdas.cu``
    under ``tree``, the entries of K7_EARLIER_ARGS) on the plan of this
    tree's rule with levels in device memory, the same K and tiles: it
    takes ``(args, tol, plan)`` as ``tv1d_pdas._launch_pdas`` does."""
    import ctypes
    from pathlib import Path
    from epsilon_tpu_torch.ops.kernels import _rows
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
    lib = ctypes.CDLL(str(_rows.build("tv1d_pdas", (), Path(tree) / "epsilon_tpu_torch" /
                                      "csrc")[0]))
    for t, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"tv1d_pdas_{t}")
        fn.argtypes = [scalar if a == "scalar" else ctypes.c_int if a == "I" else
                       ctypes.c_void_p for a in K7_EARLIER_ARGS]
        fn.restype = ctypes.c_int

    def launch(args, tol, plan):
        _, v, lam_ptr, lam_value, _, z0 = args
        n = v.shape[0]
        m, mp = n - 1, k7.padded(n - 1)
        g = k7.grid("pdas", n, v)
        x, z = torch.empty_like(v), torch.empty(m, dtype=v.dtype, device=v.device)
        gap = torch.empty((), dtype=v.dtype, device=v.device)
        rounds = torch.empty((), dtype=torch.int32, device=v.device)
        scratch = torch.empty(12 * mp + 16 * g, dtype=v.dtype, device=v.device)
        act = torch.empty(m, dtype=torch.int8, device=v.device)
        flags = torch.empty(2 * g, dtype=torch.int32, device=v.device)
        fn = getattr(lib, f"tv1d_pdas_{_rows.suffix(v)}")
        _rows.launch("tv1d_pdas", fn, (
            v.data_ptr(), None if z0 is None else z0.data_ptr(), lam_ptr, lam_value, float(tol),
            n, 40, k7.pcr_steps(m), plan.levels, plan.tile, int(plan.whole), x.data_ptr(),
            z.data_ptr(), gap.data_ptr(), rounds.data_ptr(),
            k7.sync_counter(v.device).data_ptr(), scratch.data_ptr(), act.data_ptr(),
            flags.data_ptr(), g), v)
        return x, z, gap, rounds

    return launch


def k7_tiles(rounds=K7_SWEEP_ROUNDS, sizes=(10_000, 100_000, 1_000_000), earlier=None):
    """K7's tile depth and its residue stage, in turns in this process: at
    n = 10,000, 100,000 and 1,000,000 (``fused_lasso``'s and ``tv_1d``'s
    lengths, and portbench's ``tv1d_1m``), f32 and f64, cold and warm at
    the solver's inner tolerance for the harness's rel_tol, the tile build
    at every K of K7_SWEEP_LEVELS that fits the shared memory budget, with
    the residue stage where it fits (``K=8``) and with levels in device
    memory (``K=8 dev``), and the levels build; ``rounds`` rounds of every
    side in order and reversed, each reading the median device ms of
    K7_SWEEP_REPS calls; with ``earlier``, a tree, its tile build on the
    plan of the rule without the residue stage too (``earlier``; its x, z,
    gap and rounds checked bitwise against this tree's).  Prints a line a
    case, with the dispatched plan's time over that of the rule's plan
    without the residue stage (the plan it replaces) and over the earlier
    tree's, and a JSON line of all."""
    import json
    from chip_smoke import LIBRARY_REL_TOL, tv_signal
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
    from chip_smoke import same_bits
    dev = torch.device("cuda")
    cases = []
    old = _k7_earlier(earlier) if earlier else None
    for dtype, floor in ((torch.float32, 3e-4), (torch.float64, 1e-7)):
        tol = max(0.1 * LIBRARY_REL_TOL, floor)
        for n in sizes:
            v = torch.as_tensor(tv_signal(n, 1), dtype=dtype, device=dev)
            lam = float(np.sqrt(n))
            z_cold = k7.pdas(v, lam, tol)[1]
            v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(2).randn(n), dtype=dtype,
                                            device=dev)
            g = k7.grid("pdas", n, v)
            rule = k7.tile_plan(n - 1, g, v.element_size())
            for kind, z0 in (("cold", None), ("warm", z_cold)):
                args = k7._pdas_args("tv1d_pdas", v2, lam, z0)
                sides = {}
                for levels in K7_SWEEP_LEVELS:
                    for residue, name in ((True, f"K={levels}"), (False, f"K={levels} dev")):
                        try:
                            plan = k7.tile_plan(n - 1, g, v.element_size(), levels, residue)
                        except ValueError:
                            continue
                        if plan.whole and not residue:
                            continue
                        sides[name] = (
                            lambda plan=plan: k7._launch_pdas(args, tol, 40, "tiles", plan))
                sides["levels"] = lambda: k7.pdas_levels(v2, lam, tol, z0=z0)
                if old is not None:
                    dev_plan = k7.tile_plan(n - 1, g, v.element_size(), residue=False)
                    sides["earlier"] = lambda plan=dev_plan: old(args, tol, plan)
                    mine, theirs = k7._launch_pdas(args, tol, 40, "tiles"), sides["earlier"]()
                    if not all(same_bits(a, b) for a, b in zip(mine, theirs)):
                        raise RuntimeError(f"k7-tiles: the earlier tree's x, z, gap or rounds "
                                           f"differ at n = {n}, {dtype}, {kind}")
                rounds_run = int(sides["levels"]()[3])
                readings = {side: [] for side in sides}
                for _ in range(rounds):
                    for side in list(sides) + list(sides)[::-1]:
                        readings[side].append(device_ms(sides[side], reps=K7_SWEEP_REPS,
                                                        warmup=2))
                ms = {side: (statistics.median(r), min(r), max(r))
                      for side, r in readings.items()}
                best = min((s for s in ms if s.startswith("K=")), key=lambda s: ms[s][0])
                rule_side = f"K={rule.levels}" + ("" if rule.residue else " dev")
                dev_side = f"K={k7.tile_plan(n - 1, g, v.element_size(), residue=False).levels} dev"
                ratio = ms[rule_side][0] / ms[dev_side][0] if dev_side in ms else None
                over_earlier = ms[rule_side][0] / ms["earlier"][0] if old is not None else None
                print(f"[k7-tiles] n={n} {str(dtype)[6:]} {kind} (tol {tol:g}, {rounds_run} "
                      f"rounds, grid {g}, rule K = {rule.levels}, tiles of {rule.tile} rows, "
                      f"residue groups of {rule.group}): "
                      + "; ".join(f"{side} {med:.4f} ({lo:.4f}-{hi:.4f})"
                                  for side, (med, lo, hi) in ms.items())
                      + f"; fastest {best}; dispatched ({rule_side}) / {dev_side} "
                      + ("-" if ratio is None else f"{ratio:.4f}")
                      + ("" if old is None else f"; dispatched / earlier {over_earlier:.4f}"),
                      flush=True)
                cases.append({"n": n, "dtype": str(dtype)[6:], "kind": kind, "tol": tol,
                              "rounds": rounds_run, "grid": g, "rule_levels": rule.levels,
                              "rule_group": rule.group, "ms": ms, "fastest": best,
                              "dispatched_over_device_levels": ratio,
                              "dispatched_over_earlier": over_earlier})
    print(json.dumps({"k7_tiles": cases}))


def _sass(path):
    """``(listing, {function: [(address, instruction), ...]})`` from
    ``cuobjdump -sass`` of a library."""
    import re
    from pathlib import Path
    from epsilon_tpu_torch.ops.kernels._build import _nvcc
    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(path)], check=True, capture_output=True,
                          text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return text, funcs


def _opcode(text):
    return (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]


def _sass_summary(funcs):
    """Per kernel: its instructions up to its last EXIT (the subroutines
    after it apart), its loops (a backward branch's range) and the
    longest one's opcodes, and each call site with its target and kind:
    an f64 division's slow path (``MUFU.RCP64H`` before it), an f32 IEEE
    division's (``FCHK`` just before it) or an f32 reciprocal's (the
    exponent's range test: the sigmoid's 1 / (1 + e^-x))."""
    import re
    out = {}
    for name, ins in funcs.items():
        exits = [a for a, t in ins if _opcode(t) == "EXIT"]
        body_end = exits[-1] if exits else ins[-1][0]
        main = [(a, t) for a, t in ins if a <= body_end]
        loops = []
        for addr, text in main:
            m = re.search(r"\bBRA\S*\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                start = int(m.group(1), 16)
                loops.append((start, addr, [t for a, t in main if start <= a <= addr]))
        calls = []
        for i, (addr, text) in enumerate(main):
            m = re.search(r"CALL\S*\s+(0x[0-9a-f]+)", text)
            if not m:
                continue
            before = [t for _, t in main[max(0, i - 40):i]]
            kind = ("f64 division" if any("MUFU.RCP64H" in t for t in before)
                    else "division" if any(_opcode(t) == "FCHK" for t in before[-14:])
                    else "reciprocal")
            inside = [hex(a) for a, b, _ in loops if a <= addr <= b]
            calls.append({"at": hex(addr), "target": m.group(1), "kind": kind,
                          "in_loop": bool(inside)})
        body = max(loops, key=lambda lp: len(lp[2])) if loops else None
        ops = {}
        for t in (body[2] if body else []):
            ops[_opcode(t)] = ops.get(_opcode(t), 0) + 1
        out[name] = {"instructions": len(main), "subroutines": len(ins) - len(main),
                     "loops": [(hex(a), hex(b), len(t)) for a, b, t in loops],
                     "body": len(body[2]) if body else 0,
                     "body_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
                     "calls": calls}
    return out


def _print_sass(tag, label, summary):
    """One line a kernel of ``_sass_summary``: instructions, loops, the
    longest loop's opcodes, and the slow-path calls in and out of loops."""
    for name, f in summary.items():
        looped = [c for c in f["calls"] if c["in_loop"]]
        print(f"[{tag}-sass] {label} {name}: {f['instructions']} instructions (subroutines "
              f"{f['subroutines']} more); loops {f['loops']}, the longest "
              f"{f['body']} instructions ({f['body_ops']}); slow-path calls in loops: "
              + (", ".join(f"{c['kind']} at {c['at']} -> {c['target']}" for c in looped)
                 or "none")
              + f"; outside: {len(f['calls']) - len(looped)}", flush=True)


def _registers(build_log):
    """Registers a thread of each kernel in a ``-Xptxas -v`` log, in the
    log's order."""
    import re
    return [int(m.group(1)) for m in re.finditer(r"Used (\d+) registers", build_log)]


def _resident_warps(registers, threads=256):
    """Warps an H100 SM holds of a kernel of ``registers`` a thread at
    ``threads`` a block: 65,536 registers allotted in 256s a warp, at most
    64 warps and 32 blocks."""
    per_warp = -(-registers * 32 // 256) * 256
    warps_per_block = threads // 32
    blocks = min(65536 // (per_warp * warps_per_block), 32, 64 // warps_per_block)
    return blocks * warps_per_block


def _k6_inputs(n, dtype, dev):
    from chip_smoke import k6_inputs
    v, lam = k6_inputs(n, dtype, 0, dev, "number")
    return (v,), lam


def _k6_chains(mod, name, ops, lam, steps):
    # the steps the longest element ran, and one more: the chain's own count
    from chip_smoke import k6_chain
    return {"chain": k6_chain(ops[0], lam, int(steps.max()) + 1)}


def _element_inputs(name):
    def inputs(n, dtype, dev):
        from chip_smoke import element_loop_inputs
        return element_loop_inputs(name, n, dtype, 0, dev, "number")
    return inputs


def _element_chains(mod, name, ops, lam, steps):
    # each warp its slowest element's steps, and every element the counts
    from chip_smoke import element_chain, warp_steps
    counts, entry = (mod.WIDEN_STEPS, mod.NEWTON_STEPS), mod.__name__.rsplit(".", 1)[1]
    warps = warp_steps(steps, ops[-1].numel())
    return {"chain": element_chain(name, entry, ops, lam, warps, counts),
            "full_chain": element_chain(name, entry, ops, lam, None, counts)}


# --k6, --k10 and --k9: the kernel's module, its C name, its inputs
# (phase 7a's, lam a number) and measured chains, the macro that builds
# its step marks and the marks' count (none for K9), the elements whose
# element 0 the marks read, and the cases timed in turns (elements, dtype).
ELEMENT_AB = {
    "k6": dict(module="sum_logistic", name="sum_logistic_prox", inputs=_k6_inputs,
               chains=_k6_chains, marks="K6_STEP_MARKS", mark_count=64, mark_n=1500,
               cases=((1500, torch.float32), (100_000, torch.float32),
                      (1500, torch.float64), (100_000, torch.float64))),
    "k10": dict(module="sum_inv_pos", name="sum_inv_pos_prox",
                inputs=_element_inputs("sum_inv_pos_prox"), chains=_element_chains,
                marks="K10_STEP_MARKS", mark_count=128, mark_n=10 ** 6,
                cases=((10 ** 6, torch.float32), (10 ** 6, torch.float64),
                       (10_000, torch.float32))),
    "k9": dict(module="sum_kl_div", name="sum_kl_div_prox",
               inputs=_element_inputs("sum_kl_div_prox"), chains=_element_chains, marks=None,
               cases=((10_000, torch.float32), (10_000, torch.float64),
                      (100_000, torch.float32))),
}


def element_ab(key, sides=("this",), rounds=5):
    """``--k6``, ``--k10``, ``--k9``: see the module docstring."""
    import ctypes
    import importlib
    import json
    import os
    from pathlib import Path
    from chip_smoke import launch_floor, same_bits
    from epsilon_tpu_torch.ops.kernels import _rows
    spec_of = ELEMENT_AB[key]
    source, name = spec_of["module"], spec_of["name"]
    mod = importlib.import_module(f"epsilon_tpu_torch.ops.kernels.{source}")
    dev = torch.device("cuda")
    root = Path(__file__).resolve().parents[1]
    sass_dir = f"build/{key}_sass"
    os.makedirs(sass_dir, exist_ok=True)
    libs, marked, results = {}, {}, {"sides": {}, "marks": {}, "cases": []}

    def typed(path):
        # the entries a side's library has (an older tree may lack some)
        lib = ctypes.CDLL(str(path))
        for fn, args in mod.entries().items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [
                    (ctypes.c_float if fn.endswith("_f32") else ctypes.c_double)
                    if a == "scalar" else a for a in args]
                getattr(lib, fn).restype = ctypes.c_int
        return lib

    for spec in sides:
        tree, *flags = spec.split("@")
        csrc = (root if tree == "this" else Path(tree).resolve()) / "epsilon_tpu_torch" / "csrc"
        label = (tree if tree == "this" else Path(tree).name) + "".join(f"@{f}" for f in flags)
        path, _, build_log = _rows.build(source, tuple(flags), csrc)
        libs[label] = typed(path)
        text, funcs = _sass(path)
        safe = label.replace("/", "_").replace("@", "_")
        Path(sass_dir, f"{safe}.sass").write_text(text)
        Path(sass_dir, f"{safe}.ptxas").write_text(build_log)
        regs = _registers(build_log)
        summary = _sass_summary(funcs)
        results["sides"][label] = {"registers": regs,
                                   "resident_warps": [_resident_warps(r) for r in regs],
                                   "sass": summary}
        print(f"[{key}-build] {label}: registers {regs}, resident warps an SM at 256 threads "
              f"{[_resident_warps(r) for r in regs]} (ptxas, in the log's order)", flush=True)
        _print_sass(key, label, summary)
        marks = spec_of["marks"]
        if marks and marks in (csrc / f"{source}.cu").read_text():
            mlib = typed(_rows.build(source, tuple(flags) + (f"-D{marks}",), csrc)[0])
            set_marks = getattr(mlib, f"{source}_set_marks")
            set_marks.argtypes = [ctypes.c_void_p]
            set_marks.restype = ctypes.c_int
            marked[label] = (mlib, set_marks)
    saved = mod._library()
    anchor = torch.empty(1, device=dev)
    launch_floor(anchor)
    floor_ms = device_ms(lambda: launch_floor(anchor))

    def call(lib, full, ops, lam, steps=None):
        mod._LIB = lib
        try:
            return (mod.prox_full if full else mod.prox)(*ops, lam, steps=steps)
        finally:
            mod._LIB = saved

    def steps_for(ops):
        # K6 counts its steps an element; the others their widening and Newton
        shape = tuple(ops[-1].shape) + (() if key == "k6" else (2,))
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    try:
        # cycles a step: element 0 of the main input, each build
        for label, (lib, set_marks) in marked.items():
            for dtype in (torch.float32, torch.float64):
                ops, lam = spec_of["inputs"](spec_of["mark_n"], dtype, dev)
                builds = [("dispatched", False)] + (
                    [("full", True)] if hasattr(lib, f"{name}_full_f32") else [])
                for build, full in builds:
                    marks = torch.zeros(spec_of["mark_count"], dtype=torch.int64, device=dev)
                    steps = steps_for(ops)
                    readings = []
                    for _ in range(5):
                        marks.zero_()
                        if set_marks(marks.data_ptr()) != 0:
                            raise RuntimeError(f"{source}_set_marks failed")
                        call(lib, full, ops, lam, steps)
                        torch.cuda.synchronize()
                        set_marks(None)
                        w = int(steps.reshape(-1, 2)[0, 0]) if steps.dim() == 2 else 0
                        t = marks.cpu().numpy()
                        last = int(np.flatnonzero(t)[-1])
                        # marks: 0 start, 1..w the widening's g (none for
                        # K6), w+1 and w+2 the bracket ends', w+3..last-1
                        # each Newton step's g (the steps the lane ran,
                        # cycle steps included), last the end
                        newton = last - 1 - (w + 2)
                        readings.append(((t[last - 1] - t[w + 3]) / max(newton - 1, 1),
                                         (t[w] - t[1]) / (w - 1) if w > 1 else float("nan"),
                                         t[last] - t[0], w, newton))
                    key_m = f"{label} {build} {str(dtype)[6:]}"
                    per_step = statistics.median(r[0] for r in readings)
                    widen_step = statistics.median(r[1] for r in readings)
                    total = statistics.median(r[2] for r in readings)
                    results["marks"][key_m] = {"cycles_a_newton_step": float(per_step),
                                               "cycles_a_widening_step": float(widen_step),
                                               "cycles": float(total),
                                               "widening": readings[0][3],
                                               "newton_steps_run": readings[0][4]}
                    print(f"[{key}-marks] {key_m}: element 0 ran {readings[0][3]} widening and "
                          f"{readings[0][4]} Newton steps, {per_step:.1f} cycles a Newton "
                          f"step, {widen_step:.1f} a widening step, {total:.0f} cycles in all "
                          f"(median of 5 launches of {spec_of['mark_n']} elements)", flush=True)
        # every side in turns, with the full count and the measured chains
        for n, dtype in spec_of["cases"]:
            ops, lam = spec_of["inputs"](n, dtype, dev)
            want = call(saved, True, ops, lam)
            steps = steps_for(ops)
            call(saved, False, ops, lam, steps)
            calls = {}
            for label, lib in libs.items():
                got = call(lib, False, ops, lam)
                if not all(same_bits(a, b) for a, b in zip(
                        got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,))):
                    raise AssertionError(f"{key} {label} n={n} {dtype}: differs from the "
                                         "full-count build")
                calls[label] = lambda lib=lib: call(lib, False, ops, lam)
            calls["full"] = lambda: call(saved, True, ops, lam)
            calls.update(spec_of["chains"](mod, name, ops, lam, steps))
            ms = interleaved_ms(calls, rounds=rounds)
            cols = steps.reshape(n, -1).float()
            case = {"n": n, "dtype": str(dtype)[6:], "widening_mean": float(cols[:, 0].mean())
                    if cols.shape[1] == 2 else 0.0, "newton_mean": float(cols[:, -1].mean()),
                    "newton_most": int(cols[:, -1].max()), "floor_ms": floor_ms, "ms": ms}
            results["cases"].append(case)
            print(f"[{key}-ab] n={n} {str(dtype)[6:]} (steps {case['widening_mean']:.1f} + "
                  f"{case['newton_mean']:.1f} mean, {case['newton_most']} most; {rounds} "
                  f"rounds, in order and reversed, of 20 calls a reading): "
                  + "; ".join(f"{side} {med:.4f} ({lo:.4f}-{hi:.4f})"
                              for side, (med, lo, hi) in ms.items())
                  + f"; launch floor {floor_ms:.4f}; every side bitwise equal to the "
                  "full-count build", flush=True)
    finally:
        mod._LIB = saved
    print(json.dumps({key: results}))


def k2_ab(trees):
    """``--k2``: see the module docstring."""
    import ctypes
    from pathlib import Path
    from chip_smoke import K2_WIDTHS
    from epsilon_tpu_torch.ops.kernels import _build
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp
    dev, n, T = torch.device("cuda"), 8192, sp.SYM_TILE
    sides = {"this": None}
    sides.update((Path(t).name, Path(t).resolve() / "epsilon_tpu_torch" / "csrc") for t in trees)
    libs = {}
    for label, csrc in sides.items():
        lib = ctypes.CDLL(str(_build.build("sym_packed", csrc=csrc)[0]))
        for name in ("sym_packed_matmul_f32", "sym_packed_matmul_f64"):
            getattr(lib, name).argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = lib
    rng = np.random.RandomState(1)
    M = rng.standard_normal((n, n))
    M = M + M.T
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        tiles_h, ii_h, jj_h, n_pad = sp.pack_sym_tiles(M, tile=T, dtype=np_dtype)
        tiles, ii, jj = (torch.as_tensor(a, device=dev) for a in (tiles_h, ii_h, jj_h))
        row_ptr, entries = (torch.as_tensor(a, device=dev)
                            for a in sp.sym_packed_plan(ii_h, jj_h, n_pad // T))
        K, B = tiles.shape[0], n_pad // T
        entry = "sym_packed_matmul_f32" if dtype == torch.float32 else "sym_packed_matmul_f64"
        for R in (R for R in K2_WIDTHS if R > 1):
            x = torch.as_tensor(rng.standard_normal((n_pad, R)), dtype=dtype, device=dev)
            # three partial slots a tile: as many as any layout writes
            partial = torch.empty((3 * K, T, R), dtype=dtype, device=dev)
            ys = {label: torch.empty_like(x) for label in libs}

            def run(label):
                err = getattr(libs[label], entry)(
                    tiles.data_ptr(), ii.data_ptr(), jj.data_ptr(), row_ptr.data_ptr(),
                    entries.data_ptr(), x.data_ptr(), partial.data_ptr(), ys[label].data_ptr(),
                    K, B, R, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"k2 {label}: CUDA error {err}")

            for label in libs:
                run(label)
            torch.cuda.synchronize()
            same = all(torch.equal(ys[label], ys["this"]) for label in libs)
            ms = interleaved_ms({label: (lambda label=label: run(label)) for label in libs})
            print(f"[k2-ab] n={n} R={R} {str(dtype)[6:]} (5 rounds, in order and reversed, "
                  "of 20 calls a reading): "
                  + "; ".join(f"{label} {med:.4f} ({lo:.4f}-{hi:.4f})"
                              for label, (med, lo, hi) in ms.items())
                  + f"; every side bitwise equal to this tree's: {same}", flush=True)


PLAIN_AB_ROUNDS = 1
PLAIN_AB_PROFILE_ITERS = 10


@contextlib.contextmanager
def plain_entries():
    """The dispatch of ``ops/prox`` sends K6's-K11's calls to their plain
    versions while the context is open (``sum_logistic.prox`` to
    ``prox_sum_logistic_reference``, ``tv1d_pdas.pdas`` to
    ``prox_tv1d_pdas_reference``, ``epi_exp.epi`` to ``epi_exp_reference``,
    ``sum_kl_div.prox``, ``sum_inv_pos.prox``, ``w_log_w.prox_exp`` and
    ``w_log_w.prox_neg_entr`` to ``prox_sum_kl_div_reference``,
    ``prox_sum_inv_pos_reference``, ``prox_sum_exp_reference`` and
    ``prox_sum_neg_entr_reference``): the port as it ran before them."""
    from epsilon_tpu_torch.ops.kernels import (epi_exp, sum_inv_pos, sum_kl_div, sum_logistic,
                                               tv1d_pdas, w_log_w)
    from epsilon_tpu_torch.ops.prox import elementwise, tv1d

    def pdas_plain(v, lam, tol, max_iters=40, z0=None):
        x, gap, it, z = tv1d.prox_tv1d_pdas_reference(v, lam, tol=tol, max_iters=max_iters,
                                                      z0=z0, return_dual=True)
        return x, z, gap, it

    swaps = [(sum_logistic, "prox", elementwise.prox_sum_logistic_reference),
             (tv1d_pdas, "pdas", pdas_plain), (epi_exp, "epi", elementwise.epi_exp_reference),
             (sum_kl_div, "prox", elementwise.prox_sum_kl_div_reference),
             (sum_inv_pos, "prox", elementwise.prox_sum_inv_pos_reference),
             (w_log_w, "prox_exp", elementwise.prox_sum_exp_reference),
             (w_log_w, "prox_neg_entr", elementwise.prox_sum_neg_entr_reference)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), entry in zip(swaps, saved):
            setattr(mod, name, entry)


def _family_solve(family):
    """Phase 9 (f)'s family ``family`` in this one process (the solve that
    ``chip_smoke.mesh_kind_references`` holds the ranks to): its cold solve
    at the family's cap, then device operations an iteration of a profiled
    solve of the same count."""
    from torch.autograd import DeviceType
    from tools import mesh_worker as mw
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams

    def solver():
        return ProxADMMTwoBlockSolver(mw.kind_problem(family, mw.FULL), SolverParams(
            max_iterations=mw.FULL["kind_iters"][family], **mw.KINDS))
    s = solver()
    s.solve()
    torch.cuda.synchronize()
    st = s.status
    row = dict(iterations=st.num_iterations, status=st.state.value,
               ms_per_iter=st.timing.solve_usec / 1e3 / st.num_iterations)
    s = solver()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.solve()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    row["device_ops_per_iter"] = n / s.status.num_iterations
    return row


# ``eval_prox:<kind>``: the frontend builds of phase 8 (g)'s kinds that
# reach K10 and K11, with phase 8 (g)'s lam and inputs inside their domains.
EVAL_PROX_KINDS = {
    "sum_exp": (lambda ep, x: ep.sum_entries(ep.exp(x)), 0.6,
                lambda rng, n: 3.0 * rng.randn(n)),
    "sum_neg_entr": (lambda ep, x: ep.sum_entries(-ep.entr(x)), 0.8,
                     lambda rng, n: 3.0 * rng.randn(n)),
    "sum_inv_pos": (lambda ep, x: ep.sum_entries(ep.power(x, -1)), 0.5,
                    lambda rng, n: 3.0 * np.abs(rng.randn(n)) + 0.1),
}


def _eval_prox_solve(kind):
    """One ``eval_prox`` call of ``kind`` at phase 8 (g)'s 10^6 elements
    (host wall ms, the build included), then the device operations of a
    profiled second call; figures as a solve's of one iteration."""
    import epsilon_tpu_torch as ep
    from chip_smoke import EVAL_PROX_N
    build, lam, make_v = EVAL_PROX_KINDS[kind]
    v = make_v(np.random.RandomState(2), EVAL_PROX_N)

    def call():
        x = ep.Variable(EVAL_PROX_N)
        ep.eval_prox(build(ep, x), {x: v}, lam=lam)
        torch.cuda.synchronize()
        return x.value
    call()
    t0 = time.perf_counter()
    x = call()
    row = dict(iterations=1, status="evaluated", ms_per_iter=1e3 * (time.perf_counter() - t0),
               objective=float(np.abs(x).sum()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    # on the card's machine such a window with the kernel recorded no device
    # events at all (its copies included): not measured then
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    row["device_ops_per_iter"] = n if n else None
    return row


def plain_ab(specs, rounds=PLAIN_AB_ROUNDS):
    """K6-K11 against their plain versions end to end, in turns in this
    process (kernel, plain, plain, kernel): each spec a library row at its
    reference size (``row``, or ``row@set`` under a parameter set of
    ``library_reference.json``), solved cold at the harness's rel_tol and
    the reference's iteration cap with a profiled warm re-solve of
    ``PLAIN_AB_PROFILE_ITERS`` iterations, ``family:<kind>``, phase 9 (f)'s
    family in one process, or ``eval_prox:<kind>`` (``EVAL_PROX_KINDS``),
    each after one untimed run with the kernels.  Prints ms and device
    operations an iteration of both sides, iterations
    and objectives (an ``eval_prox`` call's sum of |x|), and the
    launches."""
    import json
    from chip_smoke import REFERENCE_JSON, row_launches
    refs = json.loads(REFERENCE_JSON.read_text())
    sides = {"kernel": contextlib.nullcontext, "plain": plain_entries}
    for spec in specs:
        run, _ = _spec_solves(spec, refs, profile_iters=PLAIN_AB_PROFILE_ITERS, warm=False)
        # a first run, untimed: the kernels' libraries load at their first
        # call in the process
        run()
        readings = {s: [] for s in sides}
        launched = dict.fromkeys(sides, 0)
        for _ in range(rounds):
            for side in list(sides) + list(sides)[::-1]:
                before = sum(row_launches().values())
                with sides[side]():
                    row = run()
                launched[side] += sum(row_launches().values()) - before
                readings[side].append(row)
        if launched["plain"] != 0 or launched["kernel"] == 0:
            raise AssertionError(f"{spec}: kernel launches {launched}")
        parts = []
        for side, rows in readings.items():
            ms = [r["ms_per_iter"] for r in rows]
            ops = [r["device_ops_per_iter"] for r in rows if r["device_ops_per_iter"] is not None]
            parts.append(f"{side} {statistics.median(ms):.4f} ms/iter ({min(ms):.4f}-"
                         f"{max(ms):.4f}), "
                         + (f"{statistics.median(ops):.1f} device operations/iter, " if ops
                            else "device operations not measured, ")
                         + f"iterations {sorted({r['iterations'] for r in rows})}"
                         + (f", objective {rows[0]['objective']!r}" if "objective" in rows[0]
                            else ""))
        ratio = (statistics.median(r["ms_per_iter"] for r in readings["kernel"])
                 / statistics.median(r["ms_per_iter"] for r in readings["plain"]))
        print(f"[plain-ab] {spec} in turns ({rounds} round(s) of kernel, plain, plain, "
              f"kernel): " + "; ".join(parts) + f"; ms ratio {ratio:.4f}; hand loop kernel "
              f"launches {launched}", flush=True)
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
    if sys.argv[1:2] == ["--k7-tiles"]:
        args = sys.argv[2:]
        earlier = args[args.index("--earlier") + 1] if "--earlier" in args else None
        sizes = tuple(int(a) for a in args if a.isdigit())
        k7_tiles(sizes=sizes or (10_000, 100_000, 1_000_000), earlier=earlier)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--plain-ab":
        plain_ab(sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--k2":
        k2_ab(sys.argv[2].split(","))
        return 0
    if sys.argv[1:2] in (["--k6"], ["--k10"], ["--k9"]) and len(sys.argv) <= 3:
        element_ab(sys.argv[1][2:], sys.argv[2].split(",") if len(sys.argv) == 3 else ("this",))
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
