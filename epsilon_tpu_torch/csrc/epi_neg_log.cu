// SUM_NEG_LOG epigraph per row: the projection of (v, s) onto
// {(x, t): -sum_i log x_i <= t}, one launch over a batch of rows.  On the
// main path it runs on the spectrum of a NEG_LOG_DET epigraph
// (epsilon_tpu_torch/ops/prox/matrix.py epi_neg_log_det: eigh, this
// kernel, the rebuild).
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py epi_sum_neg_log, newton_epi.py
// make_epigraph -> implicit_newton_epigraph (a 24-step lax.fori_loop), into
// one device program.  The port's plain version (epsilon_tpu_torch/ops/prox/
// elementwise.py epi_sum_neg_log_reference) issues each step as eager
// operations, about 1,400 a call.  Each step takes the closed-form prox
// x = max((v + sqrt(v^2 + 4 lam)) / 2, floor) (floor 1e-6 in f32, 1e-12 in
// f64), h = -sum log x - s - lam and h' = -sum g_i^2 / (1 + lam / x_i^2) - 1
// with g = -1/x (the diagonal metric); rows with -sum log v <= s and v > 0
// pass through.
//
// Bound: the dependent chain of the steps taken, and the launch; a row
// reads n values and writes n + 1.  The loop on lam stops once its state
// repeats, which gives the full-count result bitwise (row_loops.cuh), so the
// chain is the steps the row takes plus the final pass, each a row pass of
// a square root, a log and two divides closed by a warp sum (chip_smoke.py's
// phase 7a counts them through the steps array).
//
// Mapping: one warp per row, 4 rows a block; lane j holds element j of a
// row of up to 32 in registers, read once, and elements j, j + 32, ... of
// a longer row, read from device memory on every pass; the scalar loop on
// lam runs in every lane on sums that are the same in every lane.
//
// Entries: epi_neg_log_rows_* (the loop exits when its state repeats) and
// epi_neg_log_rows_full_* (it runs its 24 steps: the reference the exit is
// checked against bitwise, and the A/B's other side; no dispatch calls
// them).  Plain C interface for ctypes; each returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int WARPS = 4;

template <typename T>
__device__ __forceinline__ T prox_proj(T v, T lam, T floor) {
  return clamp_min(T(0.5) * (v + t_sqrt(v * v + T(4) * lam)), floor);
}

template <typename T, int E, bool EXIT>
__global__ void __launch_bounds__(32 * WARPS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* __restrict__ x, T* __restrict__ t, int* __restrict__ steps, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  Row<T, E> vr;
  vr.load(v + (long long)row * n, n, lane);
  T* xr = x + (long long)row * n;
  Steps st;
  const T s = row_scalar(s_p, s_stride, s_value, row);
  const T floor = Lim<T>::domain_eps();
  T slog = 0;
  bool pos = true;
  each<E>(n, lane, [&](int e, int i) {
    slog += t_log(vr.at(e, i));
    pos = pos && vr.at(e, i) > T(0);
  });
  if (-warp_sum(slog) <= s && warp_all(pos)) {   // inactive, inside the domain
    vr.store(xr, n, lane);
    if (lane == 0) {
      t[row] = s;
      if (steps != nullptr) st.write(steps, row);
    }
    return;
  }
  auto h = [&](T lam, T& hp) {
    T sl = 0, gmg = 0;
    each<E>(n, lane, [&](int e, int i) {
      const T xi = prox_proj(vr.at(e, i), lam, floor);
      sl += t_log(xi);
      const T g = T(-1) / xi;
      gmg += g * (g / (T(1) + lam * (T(1) / (xi * xi))));
    });
    warp_sum2(gmg, sl);
    hp = -gmg - T(1);
    return -sl - s - lam;
  };
  const T lam = implicit_newton_lam<T, EXIT>(h, 24, st.lam);
  T sl = 0;
  each<E>(n, lane, [&](int e, int i) {
    const T xi = prox_proj(vr.at(e, i), lam, floor);
    xr[i] = xi;
    sl += t_log(xi);
  });
  const T f = -warp_sum(sl);
  if (lane == 0) {
    t[row] = s + tmax(f - s, lam);
    if (steps != nullptr) st.write(steps, row);
  }
}

template <typename T, bool EXIT>
int launch(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
           void* steps, int rows, int n, void* stream) {
  if (rows > 0) {
    by_width(n, [&](auto width) {
      epi_rows<T, decltype(width)::value, EXIT>
          <<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
              static_cast<T*>(x), static_cast<T*>(t), static_cast<int*>(steps), rows, n);
    });
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define NEG_LOG_ENTRY(SUFFIX, T, EXIT)                                                      \
  int epi_neg_log_rows_##SUFFIX(const void* v, const void* s, int s_stride, T s_value,      \
                                void* x, void* t, void* steps, int rows, int n,             \
                                void* stream) {                                             \
    return launch<T, EXIT>(v, s, s_stride, s_value, x, t, steps, rows, n, stream);         \
  }

NEG_LOG_ENTRY(f32, float, true)
NEG_LOG_ENTRY(f64, double, true)
NEG_LOG_ENTRY(full_f32, float, false)
NEG_LOG_ENTRY(full_f64, double, false)

}  // extern "C"
