"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, then the sym_packed
   CUDA kernel is compiled from ``epsilon_tpu_torch/csrc``.
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

Prints a ``{"kernels": [...]}`` line, then a last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is available.
"""

import json
import statistics
import subprocess
import sys
import time

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp

    # -- 1. card and build ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    path, build_s, build_log = sp.build()
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
    log(json.dumps({"kernels": [record]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
