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
// Bound: the dependent chain (25 row passes of a square root, a log and
// two divides, each closed by a warp sum) and the launch; a row reads n
// values and writes n + 1.
//
// Mapping: one warp per row, 4 rows a block; lane j holds elements j,
// j + 32, ...; the scalar loop on lam runs in every lane on sums that are
// the same in every lane.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int WARPS = 4;

template <typename T>
__device__ __forceinline__ T prox_proj(T v, T lam, T floor) {
  return clamp_min(T(0.5) * (v + t_sqrt(v * v + T(4) * lam)), floor);
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* __restrict__ x, T* __restrict__ t, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* vr = v + (long long)row * n;
  T* xr = x + (long long)row * n;
  const T s = row_scalar(s_p, s_stride, s_value, row);
  const T floor = Lim<T>::domain_eps();
  T slog = 0;
  bool pos = true;
  for (int i = lane; i < n; i += 32) {
    slog += t_log(vr[i]);
    pos = pos && vr[i] > T(0);
  }
  if (-warp_sum(slog) <= s && warp_all(pos)) {   // inactive, inside the domain
    for (int i = lane; i < n; i += 32) xr[i] = vr[i];
    if (lane == 0) t[row] = s;
    return;
  }
  auto h = [&](T lam, T& hp) {
    T sl = 0, gmg = 0;
    for (int i = lane; i < n; i += 32) {
      const T xi = prox_proj(vr[i], lam, floor);
      sl += t_log(xi);
      const T g = T(-1) / xi;
      gmg += g * (g / (T(1) + lam * (T(1) / (xi * xi))));
    }
    hp = -warp_sum(gmg) - T(1);
    return -warp_sum(sl) - s - lam;
  };
  const T lam = implicit_newton_lam<T>(h, 24);
  T sl = 0;
  for (int i = lane; i < n; i += 32) {
    const T xi = prox_proj(vr[i], lam, floor);
    xr[i] = xi;
    sl += t_log(xi);
  }
  const T f = -warp_sum(sl);
  if (lane == 0) t[row] = s + tmax(f - s, lam);
}

template <typename T>
int launch(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
           int rows, int n, void* stream) {
  if (rows > 0) {
    epi_rows<T><<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
        static_cast<T*>(x), static_cast<T*>(t), rows, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int epi_neg_log_rows_f32(const void* v, const void* s, int s_stride, float s_value,
                         void* x, void* t, int rows, int n, void* stream) {
  return launch<float>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

int epi_neg_log_rows_f64(const void* v, const void* s, int s_stride, double s_value,
                         void* x, void* t, int rows, int n, void* stream) {
  return launch<double>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

}  // extern "C"
