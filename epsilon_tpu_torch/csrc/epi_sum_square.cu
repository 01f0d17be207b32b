// SUM_SQUARE epigraph per row: the projection of (v, s) onto
// {(x, t): ||x||^2 <= t}, one launch over a batch of rows.
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/registry.py _epi_sum_square, whose widening of the
// bracket (40 steps) and safeguarded Newton on the cubic (util.py
// newton_safeguarded, 25 steps) are lax.fori_loops, into one device program.
// The port's plain version (epsilon_tpu_torch/ops/prox/registry.py
// _epi_sum_square_reference) issues each step as eager operations, about
// 2,000 a call.  lam >= max(0, -s) solves (s + lam)(1 + 2 lam)^2 = ||v||^2;
// then x = v / (1 + 2 lam), t = s + lam, and rows with ||v||^2 <= s pass
// through.
//
// Bound: the dependent chain of the scalar loops (67 steps of a few
// dependent operations each) and the launch; a row reads n values and
// writes n + 1.
//
// Mapping: one block per row (32 to 256 threads, by the row's width): the
// block sums v^2 (lane-strided, a warp butterfly, then the warps' partials
// in a fixed order), every thread runs the scalar loops on that one sum
// (the same value in every thread, so no thread diverges and no second
// barrier is needed), and the block writes x.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* __restrict__ x, T* __restrict__ t, int n) {
  __shared__ T partial[MAX_THREADS / 32];
  const int row = blockIdx.x;
  const T* vr = v + (long long)row * n;
  T* xr = x + (long long)row * n;
  T acc = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += vr[i] * vr[i];
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = acc;
  __syncthreads();
  T u2 = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) u2 += partial[w];
  const T s = row_scalar(s_p, s_stride, s_value, row);
  if (u2 <= s) {   // inactive: (v, s) is in the epigraph
    for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = vr[i];
    if (threadIdx.x == 0) t[row] = s;
    return;
  }
  auto g = [&](T lam) {
    const T a = T(1) + T(2) * lam;
    return (s + lam) * (a * a) - u2;
  };
  auto g_and_gp = [&](T lam, T& gp) {
    gp = (T(1) + T(2) * lam) * (T(1) + T(6) * lam + T(4) * s);
    return g(lam);
  };
  const T lo = clamp_min(-s, T(0));
  T hi = lo + t_sqrt(u2) + u2 + T(1);
#pragma unroll 1
  for (int k = 0; k < 40; ++k) hi = g(hi) < T(0) ? T(2) * hi : hi;
  const T lam = newton_safeguarded<T>(g_and_gp, T(0.5) * (lo + hi), lo, hi, 25);
  const T scale = T(1) + T(2) * lam;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = vr[i] / scale;
  if (threadIdx.x == 0) t[row] = s + lam;
}

template <typename T>
int launch(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
           int rows, int n, void* stream) {
  if (rows > 0) {
    int threads = (n + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
    epi_rows<T><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
        static_cast<T*>(x), static_cast<T*>(t), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int epi_sum_square_rows_f32(const void* v, const void* s, int s_stride, float s_value,
                            void* x, void* t, int rows, int n, void* stream) {
  return launch<float>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

int epi_sum_square_rows_f64(const void* v, const void* s, int s_stride, double s_value,
                            void* x, void* t, int rows, int n, void* stream) {
  return launch<double>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

}  // extern "C"
