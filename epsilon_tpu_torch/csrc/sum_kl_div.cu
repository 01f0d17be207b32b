// SUM_KL_DIV prox, elementwise: for f(x, y) = x log(x/y) - x + y, the
// prox of (u, v) with weight lam, one launch over every element.  On the
// main path it is the two-argument family of the meshed solver
// (ops/prox/registry.py, stacked too) and each of the 24 implicit-Newton
// steps of the SUM_KL_DIV epigraph (ops/prox/newton_epi.py epi_sum_kl_div).
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py prox_sum_kl_div (a 60-step
// lax.fori_loop that widens the bracket, then util.py newton_safeguarded,
// 60 steps) into one device program.  The port's plain version
// (epsilon_tpu_torch/ops/prox/elementwise.py prox_sum_kl_div_reference)
// issues each step as eager operations, about 3,200 a call.  Each element,
// as the plain version computes it, with r = x / y:
//   g(r) = lam r r + (v - lam) r - u + lam log r,
//   g'(r) = 2 lam r + (v - lam) + lam / r (in that order);
//   lo = max((lam - v) / lam + eps, eps) (eps 1e-6 in f32, 1e-13 in f64);
//   hi = max(2 lo, 1), doubled 60 times where g(hi) < 0;
//   r = the safeguarded Newton from min(max(max((0.5 + lam - v) / lam,
//     eps), lo), hi) in [lo, hi], 60 steps;
//   y = lam r + v - lam, x = y r;
//   (x, y) = (u, v) where |u| and |v| are both below eps^2.
// The source is built with --fmad=false, so every step rounds where the
// plain version rounds and takes its branches (row_loops.cuh).
//
// The exit.  The widening's state is hi alone, so it stops at the first
// step that leaves hi unchanged (period 1, row_loops.cuh widen()), which
// gives the full count's bits.  The Newton runs its 60 steps
// (newton_element() without the exit): every warp of the main path's
// 10,000 elements holds a lane that runs all 60 (36.8 on average), and the
// exit's state comparisons cost more than they save.  Measured in turns on
// an H100 (tools/profile_port.py --k9): 0.0229 ms at 10,000 f32, against
// 0.0284 with the Newton's exit every fourth step and 0.0259 with the
// widening's count run too.  The steps array, where given, receives each
// element's widening and Newton steps.
//
// Bound: an element reads u, v (and lam, where it has one an element) and
// writes x and y: the main path's 10,000 elements are a few hundred kB, so
// a call is bound by its launch and by one thread's dependent chain
// (chip_smoke.py times launch_floor.cu kl_div_chain).
//
// Mapping: one thread an element, row_loops.cuh element_threads() a block.
// u, v and lam arrive as rows of n elements, each with a row stride and a
// column stride (the two-argument family and the KL epigraph pass u and v
// as views of one packed tensor, a row's u and v side by side, and the
// epigraph lam one a row: column stride 0): element i of the joint shape
// reads row i / n, column i % n; strides n and 1 are a contiguous tensor,
// read at i.
//
// Entries: sum_kl_div_prox_* (the widening exits) and
// sum_kl_div_prox_full_* (both loops run their counts: the reference the
// widening's exit is checked against bitwise; no dispatch calls them).  lam is read from device memory
// (strides 0 and 0: one value) or passed by value (lam_p null).  Plain C
// interface for ctypes; each returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;
constexpr int WIDEN_STEPS = 60;
constexpr int NEWTON_STEPS = 60;

// the plain version's eps: 1e-6 in f32, 1e-13 in f64
template <typename T> __host__ __device__ constexpr double kl_eps() {
  return sizeof(T) == 4 ? 1e-6 : 1e-13;
}

// element i of a tensor read as rows of n: row i / n at row stride rs,
// column i % n at column stride cs (1, or 0 for one value a row)
template <typename T>
__device__ __forceinline__ T at_row(const T* p, long long rs, long long cs, long long n,
                                    long long i) {
  return rs == n && cs == 1 ? p[i] : p[(i / n) * rs + (i % n) * cs];
}

template <typename T, bool EXIT>
__global__ void __launch_bounds__(MAX_THREADS)
prox_kl_div(const T* u, long long u_rs, long long u_cs, const T* v, long long v_rs,
            long long v_cs, long long row_n, const T* lam_p, long long lam_rs, long long lam_cs,
            T lam_value, T* __restrict__ x_out, T* __restrict__ y_out, int* __restrict__ steps,
            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T ui = at_row(u, u_rs, u_cs, row_n, i);
  const T vi = at_row(v, v_rs, v_cs, row_n, i);
  const T lam = lam_p == nullptr ? lam_value : at_row(lam_p, lam_rs, lam_cs, row_n, i);
  const T eps = T(kl_eps<T>());
  auto g = [&](T r, T& gp) {
    gp = T(2) * lam * r + (vi - lam) + lam / r;
    return lam * r * r + (vi - lam) * r - ui + lam * t_log(r);
  };
  // y = lam r + v - lam > 0 needs r > (lam - v) / lam
  const T lo = clamp_min((lam - vi) / lam + eps, eps);
  int widened;
  const T hi = widen<EXIT>(clamp_min(lo * T(2), T(1)), WIDEN_STEPS, [&](T b) {
    T unused;
    return g(b, unused) < T(0) ? T(2) * b : b;
  }, widened);
  const T r0 = tmin(tmax(clamp_min((T(0.5) + lam - vi) / lam, eps), lo), hi);
  int ran = 0;
  const T r = newton_element<T, false>(g, r0, lo, hi, NEWTON_STEPS, ran);
  const T y = lam * r + vi - lam;
  const T x = y * r;
  const T eps2 = T(kl_eps<T>() * kl_eps<T>());
  const bool tiny = fabs(ui) < eps2 && fabs(vi) < eps2;
  x_out[i] = tiny ? ui : x;
  y_out[i] = tiny ? vi : y;
  if (steps != nullptr) {
    steps[2 * i] = widened;
    steps[2 * i + 1] = ran;
  }
}

template <typename T, bool EXIT>
int launch(const void* u, long long u_rs, long long u_cs, const void* v, long long v_rs,
           long long v_cs, long long row_n, const void* lam, long long lam_rs, long long lam_cs,
           T lam_value, void* x, void* y, void* steps, long long n, void* stream) {
  if (n > 0) {
    const int threads = element_threads(n);
    prox_kl_div<T, EXIT><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), u_rs, u_cs, static_cast<const T*>(v), v_rs, v_cs, row_n,
        static_cast<const T*>(lam), lam_rs, lam_cs, lam_value, static_cast<T*>(x),
        static_cast<T*>(y), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define KL_DIV_ENTRY(SUFFIX, T, EXIT)                                                      \
  int sum_kl_div_prox_##SUFFIX(const void* u, long long u_rs, long long u_cs, const void* v, \
                               long long v_rs, long long v_cs, long long row_n,           \
                               const void* lam, long long lam_rs, long long lam_cs,       \
                               T lam_value, void* x, void* y, void* steps, long long n,   \
                               void* stream) {                                           \
    return launch<T, EXIT>(u, u_rs, u_cs, v, v_rs, v_cs, row_n, lam, lam_rs, lam_cs,     \
                           lam_value, x, y, steps, n, stream);                           \
  }

KL_DIV_ENTRY(f32, float, true)
KL_DIV_ENTRY(f64, double, true)
KL_DIV_ENTRY(full_f32, float, false)
KL_DIV_ENTRY(full_f64, double, false)

}  // extern "C"
