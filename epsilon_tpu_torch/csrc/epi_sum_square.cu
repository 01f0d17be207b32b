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
// The exit.  Both loops stop once their state repeats, which gives the
// full-count result bitwise (row_loops.cuh iterate()).  The widening's
// state is hi: its start lo + sqrt(u2) + u2 + 1 already has g(hi) > 0 on
// every finite row, so it repeats at step 1.  The Newton's state (x, lo,
// hi, glo, ghi) repeats with period 2-4 once x settles at the root, as on
// the LOG_SUM_EXP prox's nu (tests/test_torch_loop_exit.py).
//
// Bound: the dependent chain of the steps taken (a few dependent
// operations a step) and the launch; a row reads n values and writes
// n + 1.  chip_smoke.py's phase 7a counts the steps through the steps
// array and times an empty kernel through the same ctypes path (the
// launch floor) beside it.
//
// Mapping: one block per row (32 to 256 threads, by the row's width): the
// block sums v^2 (lane-strided, a warp butterfly, then the warps' partials
// in a fixed order), every thread runs the scalar loops on that one sum
// (the same value in every thread, so no thread diverges and no second
// barrier is needed), and the block writes x.  One warp a row, as K3 and
// K5 take it, was slower at the main path's row of 200 (each lane reads
// seven elements where a thread of the block reads one) and 4.93 times
// slower at one row of 65,536 on an H100 (PERF.md, K4's mapping A/B).
//
// Entries: epi_sum_square_rows_* (the loops exit when their state
// repeats) and epi_sum_square_rows_full_* (both run their counts: the
// reference the exit is checked against bitwise, and the A/B's other side;
// no dispatch calls them).  Plain C interface for ctypes; each entry
// returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;

template <typename T, bool EXIT>
__global__ void __launch_bounds__(MAX_THREADS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* __restrict__ x, T* __restrict__ t, int* __restrict__ steps, int n) {
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
  Steps st;
  if (u2 <= s) {   // inactive: (v, s) is in the epigraph
    for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = vr[i];
    if (threadIdx.x == 0) {
      t[row] = s;
      if (steps != nullptr) st.write(steps, row);
    }
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
  const T hi = iterate<EXIT>(lo + t_sqrt(u2) + u2 + T(1), 40,
                             [&](T h) { return g(h) < T(0) ? T(2) * h : h; }, st.nu);
  const T lam = newton_safeguarded<T, EXIT>(g_and_gp, T(0.5) * (lo + hi), lo, hi, 25, &st.lam);
  const T scale = T(1) + T(2) * lam;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = vr[i] / scale;
  if (threadIdx.x == 0) {
    t[row] = s + lam;
    if (steps != nullptr) st.write(steps, row);
  }
}

template <typename T, bool EXIT>
int launch(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
           void* steps, int rows, int n, void* stream) {
  if (rows > 0) {
    int threads = (n + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
    epi_rows<T, EXIT><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
        static_cast<T*>(x), static_cast<T*>(t), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SUM_SQUARE_ENTRY(SUFFIX, T, EXIT)                                                   \
  int epi_sum_square_rows_##SUFFIX(const void* v, const void* s, int s_stride, T s_value,   \
                                   void* x, void* t, void* steps, int rows, int n,          \
                                   void* stream) {                                          \
    return launch<T, EXIT>(v, s, s_stride, s_value, x, t, steps, rows, n, stream);         \
  }

SUM_SQUARE_ENTRY(f32, float, true)
SUM_SQUARE_ENTRY(f64, double, true)
SUM_SQUARE_ENTRY(full_f32, float, false)
SUM_SQUARE_ENTRY(full_f64, double, false)

}  // extern "C"
