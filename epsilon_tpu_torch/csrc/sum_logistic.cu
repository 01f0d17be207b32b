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
// and by one thread's dependent chain of Newton steps, which chip_smoke.py
// times as an empty-handed chain of the same arithmetic (launch_floor.cu
// k6_chain).  The loop stops once its state (x, lo, hi, glo, ghi) repeats,
// which gives the full-count result bitwise (row_loops.cuh iterate4(),
// checked every fourth step); the steps array, where given, receives each
// element's steps.
//
// Mapping: one thread an element, row_loops.cuh element_threads() a block
// (the launch spread over every SM); each thread's loop is its own (no
// shuffles), so it exits at its own repeat.
//
// Built with -DK6_STEP_MARKS, element 0 reads clock64() at the start, at
// each evaluation of g and at the end (MARK; tools/profile_port.py --k6
// reads them as cycles a step); the port's build has no marks.
//
// Entries: sum_logistic_prox_* (the loop exits when its state repeats) and
// sum_logistic_prox_full_* (it runs its 40 steps: the reference the exit is
// checked against bitwise; no dispatch calls them), and sum_logistic_threads
// (the block size a launch of n takes).  Plain C interface for ctypes; each
// launch entry returns cudaGetLastError().

#include "row_loops.cuh"

#ifdef K6_STEP_MARKS
// tools/profile_port.py --k6: element 0 reads clock64() into step_marks
// (set by sum_logistic_set_marks; none while it is null), at most
// MARK_COUNT marks.
constexpr int MARK_COUNT = 64;
__device__ long long* step_marks = nullptr;
#define MARK(q)                                                         \
  do {                                                                  \
    const int mark_at = (q);                                            \
    if (step_marks != nullptr && i == 0 && mark_at < MARK_COUNT)        \
      step_marks[mark_at] = clock64();                                  \
  } while (0)
#else
#define MARK(q) \
  do {          \
  } while (0)
#endif

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;
constexpr int STEPS = 40;

// torch's CUDA sigmoid: one / (one + exp(-a)) in the element type
template <typename T> __device__ __forceinline__ T sigmoid(T a) {
  return T(1) / (T(1) + t_exp(-a));
}

template <typename T, bool EXIT>
__global__ void __launch_bounds__(MAX_THREADS)
prox_logistic(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
              T* __restrict__ x, int* __restrict__ steps, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int q = 0;
  MARK(q++);
  const T vi = v[i];
  const T lam = lam_p == nullptr ? lam_value : lam_p[i * lam_stride];
  auto g = [&](T xx, T& gp) {
    MARK(q++);
    const T s = sigmoid(xx);
    gp = T(1) + lam * s * (T(1) - s);
    return xx + lam * s - vi;
  };
  const T x0 = vi - lam * sigmoid(vi);
  int ran = 0;
  const T xi = newton_element<T, EXIT>(g, x0, vi - lam - T(1e-9), vi + T(1e-9), STEPS, ran);
  MARK(q++);
  x[i] = xi;
  if (steps != nullptr) steps[i] = ran;
}

template <typename T, bool EXIT>
int launch(const void* v, const void* lam, int lam_stride, T lam_value, void* x, void* steps,
           long long n, void* stream) {
  if (n > 0) {
    const int threads = element_threads(n);
    prox_logistic<T, EXIT><<<(unsigned)((n + threads - 1) / threads), threads, 0,
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

int sum_logistic_threads(long long n) { return element_threads(n); }

#ifdef K6_STEP_MARKS
// Where the step marks go on the current device (nullptr: none).
int sum_logistic_set_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(step_marks, &marks, sizeof(marks));
}
#endif

}  // extern "C"
