"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, then both CUDA kernels
   (sym_packed, local_update) are compiled from ``epsilon_tpu_torch/csrc``,
   one ``nvcc`` each, started together.
2. Kernel against its plain PyTorch version on the card, at the shape the
   main path gives it (n = 8192, R = 1) and at R = 8, in f32 and f64:
   maximum error, bitwise repeatability, and CUDA-event times of the
   kernel, the plain version and a dense matmul with the full matrix (device
   time, and the per-call time when calls are issued back to back).
3. Flagship lasso 2000 x 1000 through ``Problem.solve`` (f32, rho 1,
   rel_tol 1e-3), checked against numpy/scipy in f64.
4. The slice configuration, lasso 16384 x 8192 through ``Problem.solve`` in
   the default CUDA mode (explicit inverse, so the 8192-dimensional pivot
   applies through the sym_packed kernel every iteration), with the launch
   count and the same f64 check.
5. Kernel K1 (fused consensus local update) against its plain PyTorch
   version at (S, n) = (200, 200) in f32 and f64 (the consensus row's
   shape), (40, 5000) in f32 (4 GB of inverses, generated on the card) and
   the ragged (8, 130) in f32 and f64: error, bitwise repeatability, two rho
   values through one loaded library, and device times of the kernel, the
   plain version and a ``Finv.sum()`` read of the same bytes.
6. Consensus lasso at full width (bench.py's consensus row: 200 blocks of
   2500 x 200, 1e8 nonzeros, seed 0, lambda 0.1, rho 1, f32) through
   ``consensus_lasso_solver`` in the default CUDA mode (explicit inverse, so
   K1 runs every iteration): a solve to rel_tol 1e-5 checked in f64 numpy
   on the stacked problem and against a numpy f64 consensus iteration, the
   set-up timed in pieces, bench.py's steady re-solves of 500 iterations,
   and the K1 launch count.

Prints a ``{"kernels": [...]}`` line, then a last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is available.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.linalg
import torch

# Phase 2 tolerance, relative to max |plain result|: the kernel sums in
# another order than torch.bmm + index_add_.
KERNEL_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# Lasso optimality: max over i of the subgradient violation of
# A'(Ax - b) + lam * sign(x), divided by lam.  ADMM stopped at rel_tol 1e-3
# leaves about 7e-4 here (measured on the CPU in f64 at 2000 x 1000).
KKT_TOL = 1e-2
# Flagship objective against the numpy two-block iteration run to 1e-12.
OBJ_RTOL = 1e-4
# Iterations of the timed warm re-solve of the 16384 x 8192 lasso.
STEADY_ITERS = 200
# Phase 5 tolerance, relative to max |plain result|: the kernel sums in
# another order than torch.bmm.
LOCAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# Phase 6: consensus z (f32 on the card) against a numpy f64 consensus
# iteration run for the same count of iterations.  The port in f32 on the
# CPU drifted 1.4e-7 to 3.4e-7 from it at 20 and 40 blocks of 2500 x 200
# (max |z| about 2).
CONSENSUS_Z_ATOL = 1e-5
# bench.py's consensus row: re-solves of 500 iterations, epochs of 50.
CONSENSUS_STEADY_ITERS = 500
CONSENSUS_REPS = 3
# Spin before each device-timed call (about 1 ms): longer than any host
# enqueue time of the calls timed.
HEAD_START_CYCLES = 2_000_000


def log(msg):
    print(msg, flush=True)


def workload(m, n, seed=0):
    """The flagship generator (bench.py's lasso workload)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()
    return A, b, lam


def lasso_objective(A, b, lam, x):
    return 0.5 * float(np.sum((A @ x - b) ** 2)) + lam * float(np.abs(x).sum())


def kkt_violation(A, b, lam, x):
    g = A.T @ (A @ x - b)
    r = np.where(x != 0, np.abs(g + lam * np.sign(x)),
                 np.maximum(np.abs(g) - lam, 0.0))
    return float(r.max() / lam)


def numpy_two_block(A, b, lam, tol=1e-12, max_iters=20000):
    """The reference's two-block sweep in f64 numpy, run to a tight
    tolerance (bench.py's CPU iteration)."""
    n = A.shape[1]
    F = scipy.linalg.cho_factor(A.T @ A + np.eye(n))
    Atb = A.T @ b
    z = u1 = u2 = x2 = np.zeros(n)
    for _ in range(max_iters):
        x1 = scipy.linalg.cho_solve(F, Atb + z - u1)
        v = z - u2
        x2 = np.sign(v) * np.maximum(np.abs(v) - lam, 0.0)
        z_prev, z = z, 0.5 * (x1 + u1 + x2 + u2)
        u1 = u1 + x1 - z
        u2 = u2 + x2 - z
        if np.linalg.norm(x1 - z) < tol and np.linalg.norm(z - z_prev) < tol:
            break
    return x2


def _timed(fn, reps, head_start):
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=50):
    """Median device milliseconds of fn(), from CUDA events.  A spin kernel
    queued first keeps the card busy while the host enqueues fn, so the
    events bracket the device work only, not the launch overhead."""
    return _timed(fn, reps, head_start=True)


def call_ms(fn, reps=50):
    """Median milliseconds of one call of fn() issued back to back, as the
    solver loop issues it: device time or host launch time, whichever is
    longer."""
    return _timed(fn, reps, head_start=False)


def phase_kernel(sp):
    """Kernel against the plain version at n = 8192; returns the JSON
    record for the main path's shape (R = 1, f32)."""
    n, T = 8192, sp.SYM_TILE
    rng = np.random.RandomState(1)
    M = rng.standard_normal((n, n))
    M = M + M.T
    dev = torch.device("cuda")
    record = None
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        tiles_h, ii_h, jj_h, n_pad = sp.pack_sym_tiles(M, tile=T, dtype=np_dtype)
        tiles = torch.as_tensor(tiles_h, device=dev)
        ii = torch.as_tensor(ii_h, device=dev)
        jj = torch.as_tensor(jj_h, device=dev)
        row_ptr, entries = sp.sym_packed_plan(ii_h, jj_h, n_pad // T)
        plan = (torch.as_tensor(row_ptr, device=dev), torch.as_tensor(entries, device=dev))
        dense = torch.as_tensor(M, dtype=dtype, device=dev)
        for R in (1, 8):
            x = torch.as_tensor(rng.standard_normal((n_pad, R)), dtype=dtype, device=dev)
            y = sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            y2 = sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            ref = sp.sym_packed_matmul_reference(tiles, ii, jj, x)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (y - ref).abs().max().item()
            if not err <= KERNEL_RTOL[dtype] * scale:
                raise AssertionError(f"sym_packed {dtype} R={R}: max error {err} "
                                     f"> {KERNEL_RTOL[dtype]} * {scale}")
            if not torch.equal(y, y2):
                raise AssertionError(f"sym_packed {dtype} R={R}: two runs differ")
            kernel = lambda: sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            plain = lambda: sp.sym_packed_matmul_reference(tiles, ii, jj, x)
            dense_mm = lambda: dense @ x
            ms, plain_ms, dense_ms = device_ms(kernel), device_ms(plain), device_ms(dense_mm)
            log(f"[2] sym_packed n={n} R={R} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(max|ref|={scale:.3e}, rtol {KERNEL_RTOL[dtype]:g}), bitwise repeatable; "
                f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"dense matmul {dense_ms:.4f} ms; back-to-back per call: kernel "
                f"{call_ms(kernel):.4f} ms, dense matmul {call_ms(dense_mm):.4f} ms")
            if dtype == torch.float32 and R == 1:
                record = {"name": "sym_packed_matmul", "route": "cuda",
                          "source": "epsilon_tpu_torch/csrc/sym_packed.cu",
                          "replaces": "epsilon_tpu/ops/pallas_kernels.py:175",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del tiles, dense
    return record


def run_lasso(ep, tag, A, b, lam, steady_iters):
    """Solve through Problem.solve at rel_tol 1e-3 and check the result in
    f64; then re-solve the same (warm-started) problem for a fixed count of
    iterations, whose time has no first-touch set-up in it.  Returns the
    solution."""
    n = A.shape[1]
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))
    t0 = time.time()
    obj = prob.solve(rel_tol=1e-3, abs_tol=1e-6, rho=1.0, warm_start=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    st = prob.solver_status
    if prob.status != "optimal":
        raise AssertionError(f"{tag}: solver state {st.state} after {st.num_iterations} iterations")
    xv = np.asarray(x.value, dtype=np.float64).ravel()
    if xv.shape != (n,) or not np.all(np.isfinite(xv)) or not np.isfinite(obj):
        raise AssertionError(f"{tag}: non-finite or misshapen solution")
    kkt = kkt_violation(A, b, lam, xv)
    if not kkt <= KKT_TOL:
        raise AssertionError(f"{tag}: optimality violation {kkt} > {KKT_TOL}")
    init_s, solve_s = st.timing.init_usec / 1e6, st.timing.solve_usec / 1e6
    log(f"{tag}: optimal in {st.num_iterations} iterations, kkt {kkt:.2e} (tol {KKT_TOL:g}); "
        f"wall {wall:.3f} s = solver set-up {init_s:.3f} s + first solve {solve_s:.3f} s "
        f"(first-touch uploads included) + compile and write-back "
        f"{wall - init_s - solve_s:.3f} s")
    first_iters = st.num_iterations

    prob.solve(rel_tol=0.0, abs_tol=0.0, rho=1.0, warm_start=True,
               epoch_iterations=100, max_iterations=steady_iters)
    torch.cuda.synchronize()
    st = prob.solver_status
    steady_s = st.timing.solve_usec / 1e6
    log(f"{tag}: steady {st.num_iterations} iterations in {steady_s:.4f} s: "
        f"{1e3 * steady_s / st.num_iterations:.4f} ms/iter, "
        f"{st.num_iterations / steady_s:.1f} iter/s")
    return xv, first_iters


def phase_local_update(lu):
    """K1 against its plain version; returns the JSON record for the
    consensus row's shape ((200, 200), f32)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    record = None
    for S, n, dtypes in ((200, 200, (torch.float32, torch.float64)),
                         (40, 5000, (torch.float32,)),
                         (8, 130, (torch.float32, torch.float64))):
        for dtype in dtypes:
            gen.manual_seed(2)
            Finv, Atb, u, z = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                               for shape in ((S, n, n), (S, n), (S, n), (n,)))
            lib = lu._library()
            errs = []
            for rho in (1.0, 0.37):
                x, xu = lu.fused_local_update(Finv, Atb, u, z, rho)
                x2, xu2 = lu.fused_local_update(Finv, Atb, u, z, rho)
                x_ref, xu_ref = lu.local_update_reference(Finv, Atb, u, z, rho)
                torch.cuda.synchronize()
                for name, got, again, ref in (("x", x, x2, x_ref), ("xu_sum", xu, xu2, xu_ref)):
                    scale = ref.abs().max().item()
                    err = (got - ref).abs().max().item()
                    if not err <= LOCAL_RTOL[dtype] * scale:
                        raise AssertionError(f"local_update ({S}, {n}) {dtype} rho={rho} {name}: "
                                             f"max error {err} > {LOCAL_RTOL[dtype]} * {scale}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"local_update ({S}, {n}) {dtype} {name}: two runs differ")
                    errs.append((err, scale))
                if rho == 1.0:
                    x_first = x
            if lu._library() is not lib or lu.build()[1] != 0.0 or torch.equal(x_first, x):
                raise AssertionError("local_update: a new rho rebuilt the library or was ignored")
            kernel = lambda: lu.fused_local_update(Finv, Atb, u, z, 0.37)
            plain = lambda: lu.local_update_reference(Finv, Atb, u, z, 0.37)
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            read_ms = device_ms(lambda: Finv.sum())
            gbps = Finv.numel() * Finv.element_size() / (ms * 1e6)
            err, scale = max(errs)
            log(f"[5] local_update S={S} n={n} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(max|ref|={scale:.3e}, rtol {LOCAL_RTOL[dtype]:g}), bitwise repeatable, "
                f"rho 1.0 and 0.37 through one library; device time: kernel {ms:.4f} ms "
                f"({gbps:.0f} GB/s on Finv), plain {plain_ms:.4f} ms, Finv.sum() {read_ms:.4f} ms; "
                f"back-to-back per call: kernel {call_ms(kernel):.4f} ms")
            if (S, n, dtype) == (200, 200, torch.float32):
                record = {"name": "fused_local_update", "route": "cuda",
                          "source": "epsilon_tpu_torch/csrc/local_update.cu",
                          "replaces": "epsilon_tpu/ops/pallas_kernels.py:72",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            del Finv, Atb, u, z
    return record


def numpy_consensus(A, b, lam, rho, iters):
    """The consensus lasso iteration in f64 numpy (explicit inverses, fixed
    rho), run for a fixed count of iterations; returns z."""
    S, m, n = A.shape
    A = A.astype(np.float64)
    b = b.astype(np.float64)
    At = A.transpose(0, 2, 1)
    Finv = np.linalg.inv(At @ A + rho * np.eye(n))
    Atb = (At @ b[:, :, None])[:, :, 0]
    thresh = lam / (S * rho)
    u = np.zeros((S, n))
    z = np.zeros(n)
    for _ in range(iters):
        x = (Finv @ (Atb + rho * (z[None, :] - u))[:, :, None])[:, :, 0]
        v = (x + u).mean(axis=0)
        z = np.sign(v) * np.maximum(np.abs(v) - thresh, 0.0)
        u = u + x - z[None, :]
    return z


def setup_pieces(A, b, rho):
    """The consensus lasso's explicit-inverse set-up, piece by piece, as
    ``consensus_lasso_solver`` runs it: upload, products on the card, host
    f64 inverses, upload of the inverses.  Returns seconds per piece."""
    t = [time.perf_counter()]
    A_d, b_d = torch.as_tensor(A, device="cuda"), torch.as_tensor(b, device="cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    AtA = torch.bmm(A_d.transpose(1, 2), A_d)
    torch.bmm(A_d.transpose(1, 2), b_d.unsqueeze(-1))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    Finv = np.linalg.inv(AtA.cpu().to(torch.float64).numpy() + rho * np.eye(A.shape[2]))
    t.append(time.perf_counter())
    torch.as_tensor(Finv.astype(np.float32), device="cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return dict(zip(("upload", "products", "host f64 inverses", "inverse upload"),
                    np.diff(t)))


def phase_consensus(lu):
    """bench.py's consensus row on the card; returns K1's launch count."""
    from epsilon_tpu_torch.parallel import consensus_lasso_solver
    from epsilon_tpu_torch.problems.scaling_bench import make_blocks
    S, m, n, lam, rho = 200, 2500, 200, 0.1, 1.0
    t0 = time.time()
    A, b = make_blocks(S, m, n)
    log(f"[6] generated {S} blocks of {m}x{n} ({A.size:.2e} nonzeros) in {time.time() - t0:.2f} s")
    lu.launches = 0

    # (a) a solve to convergence.  At rel_tol 1e-4 the f32 solve stopped
    # after 20 iterations with KKT/lambda 1.26e-2 on an H100; 1e-5 takes
    # about 30 (4.5e-5 in f64 on the CPU).
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, lam, rho=rho, rel_tol=1e-5, abs_tol=1e-8,
                                    max_iterations=2000)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.local_update is None:
        raise AssertionError("consensus: the K1 path was not taken")
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    iters_run = res.iterations
    z = res.z.cpu().numpy().astype(np.float64)
    if not res.converged or z.shape != (n,) or not np.all(np.isfinite(z)):
        raise AssertionError(f"consensus: converged={res.converged} after {res.iterations} "
                             "iterations, or a non-finite or misshapen z")
    X = A.astype(np.float64).reshape(S * m, n)
    g = X.T @ (X @ z) - X.T @ b.astype(np.float64).ravel()
    kkt = float(np.where(z != 0, np.abs(g + lam * np.sign(z)),
                         np.maximum(np.abs(g) - lam, 0.0)).max() / lam)
    z_ref = numpy_consensus(A, b, lam, rho, res.iterations)
    dz = float(np.abs(z - z_ref).max())
    log(f"[6] consensus {S}x{m}x{n}: converged in {res.iterations} iterations "
        f"(rel_tol 1e-5), kkt {kkt:.2e} (tol {KKT_TOL:g}), {int((z != 0).sum())} nonzeros, "
        f"max|z - z_f64 iteration| {dz:.2e} (tol {CONSENSUS_Z_ATOL:g}); "
        f"set-up {setup_s:.3f} s, solve {solve_s:.3f} s")
    if not kkt <= KKT_TOL:
        raise AssertionError(f"consensus: optimality violation {kkt} > {KKT_TOL}")
    if not dz <= CONSENSUS_Z_ATOL:
        raise AssertionError(f"consensus: z differs from the f64 iteration by {dz} "
                             f"> {CONSENSUS_Z_ATOL}")
    pieces = setup_pieces(A, b, rho)
    log("[6] set-up pieces, timed apart: " + ", ".join(f"{k} {v:.3f} s" for k, v in pieces.items()))

    # (b) bench.py's steady row
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, lam, rho=rho, rel_tol=0.0, abs_tol=0.0,
                                    max_iterations=CONSENSUS_STEADY_ITERS, epoch_iterations=50)
    torch.cuda.synchronize()
    setup2_s = time.perf_counter() - t0
    iters_run += solver.solve().iterations
    ips = []
    for _ in range(CONSENSUS_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        ips.append(res.iterations / (time.perf_counter() - t0))
        iters_run += res.iterations
    log(f"[6] steady: {CONSENSUS_REPS} re-solves of {CONSENSUS_STEADY_ITERS} iterations: "
        f"median {statistics.median(ips):.1f} iter/s (min {min(ips):.1f}, max {max(ips):.1f}; "
        f"{1e3 / statistics.median(ips):.4f} ms/iter); set-up {setup2_s:.3f} s")

    # (c) K1 ran every iteration
    launches = lu.launches
    if launches < iters_run:
        raise AssertionError(f"consensus: local_update launched {launches} times "
                             f"in {iters_run} iterations")
    log(f"[6] local_update launches in the main path: {launches} ({iters_run} iterations)")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch.ops.kernels import local_update as lu
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp

    # -- 1. card and build ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(lambda mod: mod.build(), (sp, lu)))
    log(f"[1] both kernels built in {time.perf_counter() - t0:.2f} s")
    for path, build_s, build_log in builds:
        log(f"[1] built {path.name} in {build_s:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1]   {line.strip()}")

    # -- 2. kernel against the plain version -----------------------------------
    record = phase_kernel(sp)

    # -- 3. flagship lasso 2000 x 1000 ------------------------------------------
    A, b, lam = workload(2000, 1000)
    xv, _ = run_lasso(ep, "[3] lasso 2000x1000", A, b, lam, steady_iters=2000)
    f_port = lasso_objective(A, b, lam, xv)
    f_ref = lasso_objective(A, b, lam, numpy_two_block(A, b, lam))
    gap = abs(f_port - f_ref) / abs(f_ref)
    if not gap <= OBJ_RTOL:
        raise AssertionError(f"lasso 2000x1000: objective {f_port} vs f64 reference "
                             f"{f_ref}: relative gap {gap} > {OBJ_RTOL}")
    log(f"[3] lasso 2000x1000: objective {f_port:.9g} vs f64 reference {f_ref:.9g}, "
        f"relative gap {gap:.2e} (tol {OBJ_RTOL:g})")

    # -- 4. the slice configuration: lasso 16384 x 8192 ---------------------------
    t0 = time.time()
    A, b, lam = workload(16384, 8192)
    log(f"[4] generated 16384x8192 data in {time.time() - t0:.2f} s")
    sp.launches = 0
    _, iters = run_lasso(ep, "[4] lasso 16384x8192", A, b, lam, steady_iters=STEADY_ITERS)
    launches = sp.launches
    if launches < iters + STEADY_ITERS:
        raise AssertionError(f"lasso 16384x8192: sym_packed launched {launches} times "
                             f"in {iters} + {STEADY_ITERS} iterations")
    log(f"[4] sym_packed launches in the main path: {launches} "
        f"({iters} + {STEADY_ITERS} iterations)")

    record["launches"] = launches

    # -- 5. K1 against its plain version ------------------------------------------
    record_k1 = phase_local_update(lu)

    # -- 6. consensus lasso at full width -------------------------------------------
    record_k1["launches"] = phase_consensus(lu)

    log(json.dumps({"kernels": [record, record_k1]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
