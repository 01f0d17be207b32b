// SUM_LOGISTIC prox, elementwise: x solves x + lam sigmoid(x) = v, one
// launch over every element.  On the main path it is the logistic loss's
// prox in logreg_l1 and logreg_l1_sparse, and each of the 24 implicit-
// Newton steps of the SUM_LOGISTIC epigraph (ops/prox/registry.py).
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py prox_sum_logistic ->
// util.py newton_safeguarded (a 40-step lax.fori_loop) into one device
// program.  The port's plain version (epsilon_tpu_torch/ops/prox/
// elementwise.py prox_sum_logistic_reference) issues each step as eager
// operations, about 2,000 a call.  Each element runs the safeguarded Newton
// from x0 = v - lam sigmoid(v) in the bracket [v - lam - 1e-9, v + 1e-9],
// g(x) = x + lam sigmoid(x) - v and g'(x) = 1 + lam s (1 - s), with
// sigmoid(x) = 1 / (1 + exp(-x)) as torch's CUDA sigmoid computes it; the
// source is built with --fmad=false, so every step rounds where the plain
// version rounds and takes its branches (row_loops.cuh).
//
// Bound: an element reads v (and lam, where it has one an element) and
// writes x; 1,500 elements are a few kB, so a call is bound by its launch
// and by one thread's dependent chain of Newton steps.  The loop stops once
// its state (x, lo, hi, glo, ghi) repeats, which gives the full-count result
// bitwise (row_loops.cuh iterate()); the steps array, where given, receives
// each element's steps.
//
// Mapping: one thread an element, 256 a block; each thread's loop is its
// own (no shuffles), so it exits at its own first repeat.
//
// Entries: sum_logistic_prox_* (the loop exits when its state repeats) and
// sum_logistic_prox_full_* (it runs its 40 steps: the reference the exit is
// checked against bitwise; no dispatch calls them).  Plain C interface for
// ctypes; each returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int THREADS = 256;
constexpr int STEPS = 40;

// torch's CUDA sigmoid: one / (one + exp(-a)) in the element type
template <typename T> __device__ __forceinline__ T sigmoid(T a) {
  return T(1) / (T(1) + t_exp(-a));
}

template <typename T, bool EXIT>
__global__ void __launch_bounds__(THREADS)
prox_logistic(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
              T* __restrict__ x, int* __restrict__ steps, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T vi = v[i];
  const T lam = lam_p == nullptr ? lam_value : lam_p[i * lam_stride];
  auto g = [&](T xx, T& gp) {
    const T s = sigmoid(xx);
    gp = T(1) + lam * s * (T(1) - s);
    return xx + lam * s - vi;
  };
  const T x0 = vi - lam * sigmoid(vi);
  int ran = 0;
  x[i] = newton_safeguarded<T, EXIT>(g, x0, vi - lam - T(1e-9), vi + T(1e-9), STEPS, &ran);
  if (steps != nullptr) steps[i] = ran;
}

template <typename T, bool EXIT>
int launch(const void* v, const void* lam, int lam_stride, T lam_value, void* x, void* steps,
           long long n, void* stream) {
  if (n > 0) {
    prox_logistic<T, EXIT><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(lam), lam_stride, lam_value,
        static_cast<T*>(x), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define LOGISTIC_ENTRY(SUFFIX, T, EXIT)                                                   \
  int sum_logistic_prox_##SUFFIX(const void* v, const void* lam, int lam_stride,         \
                                 T lam_value, void* x, void* steps, long long n,         \
                                 void* stream) {                                         \
    return launch<T, EXIT>(v, lam, lam_stride, lam_value, x, steps, n, stream);          \
  }

LOGISTIC_ENTRY(f32, float, true)
LOGISTIC_ENTRY(f64, double, true)
LOGISTIC_ENTRY(full_f32, float, false)
LOGISTIC_ENTRY(full_f64, double, false)

}  // extern "C"
