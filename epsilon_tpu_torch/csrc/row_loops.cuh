// Device helpers shared by the per-row loop kernels (lse_rows.cu,
// epi_sum_square.cu, epi_neg_log.cu).
//
// These kernels replace fixed-count loops that the JAX package leaves to
// XLA (epsilon_tpu/ops/prox/util.py, newton_epi.py, registry.py), so that a
// kernel call runs every step of its loops in one launch instead of one
// eager PyTorch operation a step.  Each helper repeats the arithmetic of the
// port's plain PyTorch version (epsilon_tpu_torch/ops/prox/) operation by
// operation, in the same order: the sources are built with --fmad=false so
// that no multiply-add is contracted where PyTorch rounds twice, and the
// comparisons keep PyTorch's NaN behaviour (torch.maximum and torch.amax
// propagate NaN; torch.clamp keeps it), so that the kernels take the plain
// versions' branches.  Row sums are taken in a fixed order (strided partial
// sums per lane, then an xor butterfly), so results repeat bitwise; every
// lane of a warp holds the same sum, because IEEE addition is commutative.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>

namespace rowloops {

template <typename T> struct Lim;
template <> struct Lim<float> {
  // torch.finfo(float32).tiny, .max; the port's _domain_eps for float32
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
  static __device__ __forceinline__ float domain_eps() { return 1e-6f; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
  static __device__ __forceinline__ double domain_eps() { return 1e-12; }
};

__device__ __forceinline__ float t_log(float x) { return logf(x); }
__device__ __forceinline__ double t_log(double x) { return log(x); }
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ bool is_finite(T x) { return isfinite(x); }
template <typename T> __device__ __forceinline__ bool is_inf(T x) { return isinf(x); }

// torch.maximum / torch.minimum: NaN when either argument is NaN
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): NaN stays NaN
template <typename T> __device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T> __device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = tmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ bool warp_all(bool p) { return __all_sync(0xffffffffu, p); }

// util.solve_w_log_w: w + log w = c for w > 0, 30 Newton steps.
template <typename T> __device__ __forceinline__ T solve_w_log_w(T c) {
  const T tiny = Lim<T>::tiny();
  T w = c > T(1) ? c - t_log(clamp_min(c, T(1.1))) : t_exp(clamp_max(c, T(1)));
  w = clamp_min(w, tiny);
#pragma unroll 1
  for (int k = 0; k < 30; ++k) w = clamp_min(w - (w + t_log(w) - c) * w / (w + T(1)), tiny);
  return w;
}

// util.newton_safeguarded for non-decreasing g: Newton kept inside a
// bracket with endpoint residuals, Illinois regula falsi as the fallback.
// gfun(x, gp) returns g(x) and sets gp = g'(x); a warp calls it together
// when g reduces over a row.
template <typename T, typename G>
__device__ __forceinline__ T newton_safeguarded(G gfun, T x, T lo, T hi, int iters) {
  T gp;
  T glo = gfun(lo, gp);
  T ghi = gfun(hi, gp);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const T gx = gfun(x, gp);
    if (gx < T(0)) {
      lo = tmax(lo, x);
      glo = gx;
      ghi = T(0.5) * ghi;
    } else {
      hi = tmin(hi, x);
      ghi = gx;
      glo = T(0.5) * glo;
    }
    const T step = gp != T(0) ? gx / gp : T(0);
    const T xn = x - step;
    const T denom = ghi - glo;
    const T mid = T(0.5) * (lo + hi);
    T falsi = denom != T(0) ? (lo * ghi - hi * glo) / denom : mid;
    falsi = is_finite(falsi) ? tmin(tmax(falsi, lo), hi) : mid;
    const bool bad = xn <= lo || xn >= hi || !is_finite(xn);
    x = bad ? falsi : xn;
  }
  return x;
}

// newton_epi.implicit_newton_epigraph's loop on lam (the port's strict
// bracket test), 24 steps from lam = 1.  hfun(lam, hp) returns
// h(lam) = f(prox(v, lam)) - s - lam and sets hp = h'(lam).
template <typename T, typename H>
__device__ __forceinline__ T implicit_newton_lam(H hfun, int iters) {
  const T big = Lim<T>::max() / T(4);
  T lam = T(1);
  T lo = Lim<T>::domain_eps();
  T hi = big * T(2);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    T hp;
    const T h = hfun(lam, hp);
    if (h > T(0)) lo = tmax(lo, lam);
    if (h <= T(0)) hi = tmin(hi, lam);
    const T lam_n = lam - h / hp;
    const T fallback = hi >= big ? clamp_min(T(4) * lam, T(1)) : T(0.5) * (lo + hi);
    const bool bad = lam_n < lo || lam_n > hi || !is_finite(lam_n);
    lam = bad ? fallback : lam_n;
  }
  return lam;
}

// A per-row scalar: from device memory (stride 0 broadcasts one value) or,
// where the caller passed a host number, by value.
template <typename T>
__device__ __forceinline__ T row_scalar(const T* p, int stride, T value, int row) {
  return p == nullptr ? value : p[(long long)row * stride];
}

}  // namespace rowloops
