// The SUM_EXP and SUM_NEG_ENTR proxes, elementwise, one launch over every
// element: both reduce to w + log w = c (w = LambertW(e^c)), solved by
// row_loops.cuh solve_w_log_w(), the 30-step Newton that K3's LOG_SUM_EXP
// kernels run.
//   SUM_EXP, f(x) = e^x: x + lam e^x = v, so c = log(lam) + v and
//     x = v - w(c);
//   SUM_NEG_ENTR, f(x) = x log x: with x = lam w, c = (v - lam) / lam -
//     log(lam) and x = lam w(c).
// On the main path they are eval_prox of sum_entries(exp(x)) and of
// sum_entries(-entr(x)) (compiler/prox_rules.py prox_sum_exp,
// prox_sum_neg_entr), and each implicit-Newton step of those kinds'
// epigraphs.
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py prox_sum_exp and prox_sum_neg_entr
// (util.py solve_w_log_w, a 30-step lax.fori_loop) into one device program
// each.  The port's plain versions (epsilon_tpu_torch/ops/prox/
// elementwise.py prox_sum_exp_reference, prox_sum_neg_entr_reference)
// issue each step as eager operations, about 210 a call.  The source is
// built with --fmad=false, so every step rounds where the plain version
// rounds (row_loops.cuh).
//
// The exit.  The solve's state is w alone (c held): it stops at the first
// state that repeats one of the last four, checked every step, and returns
// the state of the cycle that the full count reaches (iterate()): the full
// count's bits.  The steps array, where given, receives each element's
// Lambert steps.
//
// Bound: an element reads v (and lam, where it has one an element) and
// writes x: at eval_prox's 10^6 elements 8 MB in f32, 2.4 us at the HBM
// rate, so a call is bound by its longest element's dependent chain
// (chip_smoke.py times launch_floor.cu w_log_w_chain) and, at that size,
// by the issue rate of the elements' steps.
//
// Mapping: one thread an element, row_loops.cuh element_threads() a block.
//
// Entries: w_log_w_{exp,neg_entr}_* (the solve exits) and
// w_log_w_{exp,neg_entr}_full_* (it runs its 30 steps: the reference the
// exit is checked against bitwise; no dispatch calls them).  lam is read
// from device memory (stride 1: one an element; stride 0: one value) or
// passed by value (lam_p null).  Plain C interface for ctypes; each
// returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int MAX_THREADS = 256;

enum Kind { SUM_EXP, SUM_NEG_ENTR };

template <typename T, bool EXIT, Kind KIND>
__global__ void __launch_bounds__(MAX_THREADS)
prox_w_log_w(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
             T* __restrict__ x_out, int* __restrict__ steps, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T vi = v[i];
  const T lam = lam_p == nullptr ? lam_value : lam_p[i * lam_stride];
  const T c = KIND == SUM_EXP ? t_log(lam) + vi : (vi - lam) / lam - t_log(lam);
  int ran = 0;
  const T w = solve_w_log_w<EXIT>(c, ran);
  x_out[i] = KIND == SUM_EXP ? vi - w : lam * w;
  if (steps != nullptr) steps[i] = ran;
}

template <typename T, bool EXIT, Kind KIND>
int launch(const void* v, const void* lam, int lam_stride, T lam_value, void* x, void* steps,
           long long n, void* stream) {
  if (n > 0) {
    const int threads = element_threads(n);
    prox_w_log_w<T, EXIT, KIND><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(lam), lam_stride, lam_value,
        static_cast<T*>(x), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define W_LOG_W_ENTRY(NAME, SUFFIX, T, EXIT, KIND)                                          \
  int w_log_w_##NAME##_##SUFFIX(const void* v, const void* lam, int lam_stride, T lam_value, \
                                void* x, void* steps, long long n, void* stream) {          \
    return launch<T, EXIT, KIND>(v, lam, lam_stride, lam_value, x, steps, n, stream);       \
  }

W_LOG_W_ENTRY(exp, f32, float, true, SUM_EXP)
W_LOG_W_ENTRY(exp, f64, double, true, SUM_EXP)
W_LOG_W_ENTRY(exp, full_f32, float, false, SUM_EXP)
W_LOG_W_ENTRY(exp, full_f64, double, false, SUM_EXP)
W_LOG_W_ENTRY(neg_entr, f32, float, true, SUM_NEG_ENTR)
W_LOG_W_ENTRY(neg_entr, f64, double, true, SUM_NEG_ENTR)
W_LOG_W_ENTRY(neg_entr, full_f32, float, false, SUM_NEG_ENTR)
W_LOG_W_ENTRY(neg_entr, full_f64, double, false, SUM_NEG_ENTR)

}  // extern "C"
