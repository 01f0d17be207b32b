// The EXP epigraph, elementwise: the projection of (v, s) onto
// {(x, t): e^x <= t}, one launch over every element.  On the main path it
// is max_softmax's epigraph under use_epigraph=False (the conic fallback
// states its exponential terms as EXP epigraphs) and the epigraph_elementwise
// family of the meshed solver (ops/prox/operator.py, stacked too).
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py epi_exp (a 40-step lax.fori_loop that
// widens the bracket, then util.py newton_safeguarded, 25 steps) into one
// device program.  The port's plain version (epsilon_tpu_torch/ops/prox/
// elementwise.py epi_exp_reference) issues each step as eager operations.
// Each element, as the plain version computes it:
//   inactive = exp(v) <= s;
//   lo = min(v, 0) - 1, widened 40 times: lo - 2|lo| - 2 where g(lo) > 0,
//     g(x) = x + e^x e^x - s e^x - v (in that order);
//   where s > 0, lo = max(lo, log(max(s, tiny) 0.5)) (NaN kept, tmax);
//   x = the safeguarded Newton from (lo + v) / 2 in [lo, v], 25 steps,
//     g'(x) = 1 + 2 e^x e^x - s e^x;
//   (x, t) = inactive ? (v, s) : (x, exp(x)).
// The source is built with --fmad=false, so every step rounds where the
// plain version rounds and takes its branches (row_loops.cuh).
//
// The exits.  The widening's state is lo alone: once a step leaves lo
// unchanged, every later step does, so the loop stops there (period 1,
// row_loops.cuh widen()).
// The Newton's state (x, lo, hi, glo, ghi) stops at its first repeat found
// every fourth step, the last of the 25 steps after the unrolled body
// (row_loops.cuh iterate4(), newton_element()).  Both give the full count's
// bits.  The steps array, where given, receives each element's widening and
// Newton steps.
//
// Bound: an element reads v and s and writes x and t: a few tens of kB on
// the main path, so a call is bound by its launch and by one thread's
// dependent chain (chip_smoke.py times launch_floor.cu epi_exp_chain).
//
// Mapping: one thread an element, row_loops.cuh element_threads() a block.
//
// Entries: epi_exp_* (the loops exit) and epi_exp_full_* (they run their
// counts: the reference the exits are checked against bitwise; no dispatch
// calls them).  s is read from device memory (stride 1: one an element;
// stride 0: one value) or passed by value (s_p null).  Plain C interface
// for ctypes; each returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;
constexpr int WIDEN_STEPS = 40;
constexpr int NEWTON_STEPS = 25;

template <typename T, bool EXIT>
__global__ void __launch_bounds__(MAX_THREADS)
epi_exp(const T* __restrict__ v, const T* s_p, int s_stride, T s_value, T* __restrict__ x_out,
        T* __restrict__ t_out, int* __restrict__ steps, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T vi = v[i];
  const T si = s_p == nullptr ? s_value : s_p[i * s_stride];
  const bool inactive = t_exp(vi) <= si;
  auto gfun = [&](T xx, T& gp) {
    const T ex = t_exp(xx);
    gp = T(1) + T(2) * ex * ex - si * ex;
    return xx + ex * ex - si * ex - vi;
  };
  int widened;
  T lo = widen<EXIT>(clamp_max(vi, T(0)) - T(1), WIDEN_STEPS, [&](T b) {
    T unused;
    return gfun(b, unused) > T(0) ? b - T(2) * fabs(b) - T(2) : b;
  }, widened);
  if (si > T(0)) lo = tmax(lo, t_log(clamp_min(si, Lim<T>::tiny()) * T(0.5)));
  const T hi = vi;
  int ran = 0;
  const T x = newton_element<T, EXIT>(gfun, T(0.5) * (lo + hi), lo, hi, NEWTON_STEPS, ran);
  x_out[i] = inactive ? vi : x;
  t_out[i] = inactive ? si : t_exp(x);
  if (steps != nullptr) {
    steps[2 * i] = widened;
    steps[2 * i + 1] = ran;
  }
}

template <typename T, bool EXIT>
int launch(const void* v, const void* s, int s_stride, T s_value, void* x, void* t, void* steps,
           long long n, void* stream) {
  if (n > 0) {
    const int threads = element_threads(n);
    epi_exp<T, EXIT><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
        static_cast<T*>(x), static_cast<T*>(t), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define EPI_EXP_ENTRY(SUFFIX, T, EXIT)                                                        \
  int epi_exp_##SUFFIX(const void* v, const void* s, int s_stride, T s_value, void* x, void* t, \
                       void* steps, long long n, void* stream) {                              \
    return launch<T, EXIT>(v, s, s_stride, s_value, x, t, steps, n, stream);                  \
  }

EPI_EXP_ENTRY(f32, float, true)
EPI_EXP_ENTRY(f64, double, true)
EPI_EXP_ENTRY(full_f32, float, false)
EPI_EXP_ENTRY(full_f64, double, false)

}  // extern "C"
