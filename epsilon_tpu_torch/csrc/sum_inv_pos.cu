// SUM_INV_POS prox, elementwise: for f(x) = 1/x on x > 0, x solves
// x^2 (x - v) = lam (the largest real root of x^3 - v x^2 - lam), one
// launch over every element.  On the main path it is eval_prox of
// sum_entries(power(x, -1)) (compiler/prox_rules.py prox_sum_inv_pos) and
// each implicit-Newton step of the SUM_INV_POS epigraph.
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/elementwise.py prox_sum_inv_pos (a 40-step
// lax.fori_loop that widens the bracket, then util.py newton_safeguarded,
// 50 steps) into one device program.  The port's plain version
// (epsilon_tpu_torch/ops/prox/elementwise.py prox_sum_inv_pos_reference)
// issues each step as eager operations, about 2,200 a call.  Each element,
// as the plain version computes it:
//   g(x) = x x (x - v) - lam, g'(x) = 3 x x - 2 v x (in that order);
//   c = sign(lam) |lam| ** (1/3) (the port's _cbrt, row_loops.cuh
//     torch_cbrt(): torch's sign and pow, not cbrtf);
//   hi = max(v, 0) + c + 1, doubled 40 times where g(hi) < 0;
//   x = the safeguarded Newton from max(v, c) in [1e-12, hi], 50 steps.
// The source is built with --fmad=false, so every step rounds where the
// plain version rounds and takes its branches (row_loops.cuh).
//
// The exit.  The widening's state is hi alone, so it stops at the first
// step that leaves hi unchanged (period 1, row_loops.cuh widen()), which
// gives the full count's bits.  The Newton runs its 50 steps
// (newton_element() without the exit): a warp runs at the pace of its
// slowest lane, nearly every warp of eval_prox's 10^6 elements holds a
// lane that runs all 50 (23.9 steps on average), and the exit's state
// comparisons cost more than the steps they save.  Measured in turns on an
// H100 (tools/profile_port.py --k10): 0.194 ms at 10^6 f32, against 0.244
// with the Newton's exit every fourth step, 0.249 with one exit for the
// whole warp, 0.208 with the widening's count run too.  The regula falsi
// point is computed in every step and selected (no branch), as in K6: the
// variant that computes it only where a lane of the warp takes it (a vote)
// measured slower (0.214).  The steps array, where given, receives each
// element's widening and Newton steps.
//
// Bound: an element reads v (and lam, where it has one an element) and
// writes x: at eval_prox's 10^6 elements 8 MB in f32, 2.4 us at the HBM
// rate, so a call is bound by its longest element's dependent chain
// (chip_smoke.py times launch_floor.cu inv_pos_chain) and, at that size,
// by the issue rate of the elements' steps: about 78 instructions a Newton
// step in f32, 18 of them the two IEEE divisions' fast paths.
//
// Mapping: one thread an element, row_loops.cuh element_threads() a block.
//
// Built with -DK10_STEP_MARKS, element 0 reads clock64() at the start, at
// each evaluation of g and at the end (MARK; tools/profile_port.py --k10
// reads them as cycles a step); the port's build has no marks.
//
// Entries: sum_inv_pos_prox_* (the widening exits) and
// sum_inv_pos_prox_full_* (both loops run their counts: the reference the
// widening's exit is checked against bitwise; no dispatch calls them).  lam is read from device memory
// (stride 1: one an element; stride 0: one value) or passed by value
// (lam_p null).  Plain C interface for ctypes; each returns
// cudaGetLastError().

#include "row_loops.cuh"

#ifdef K10_STEP_MARKS
// tools/profile_port.py --k10: element 0 reads clock64() into step_marks
// (set by sum_inv_pos_set_marks; none while it is null) at the start, at
// each evaluation of g (the widening's, the bracket ends', each Newton
// step's) and at the end, at most MARK_COUNT marks.
constexpr int MARK_COUNT = 128;
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
constexpr int WIDEN_STEPS = 40;
constexpr int NEWTON_STEPS = 50;

template <typename T, bool EXIT>
__global__ void __launch_bounds__(MAX_THREADS)
prox_inv_pos(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
             T* __restrict__ x_out, int* __restrict__ steps, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int q = 0;
  MARK(q++);
  const T vi = v[i];
  const T lam = lam_p == nullptr ? lam_value : lam_p[i * lam_stride];
  auto g = [&](T x, T& gp) {
    MARK(q++);
    gp = T(3) * x * x - T(2) * vi * x;
    return x * x * (x - vi) - lam;
  };
  const T c = torch_cbrt(lam);
  int widened;
  const T hi = widen<EXIT>(clamp_min(vi, T(0)) + c + T(1), WIDEN_STEPS, [&](T b) {
    T unused;
    return g(b, unused) < T(0) ? T(2) * b : b;
  }, widened);
  int ran = 0;
  const T xi = newton_element<T, false>(g, tmax(vi, c), T(1e-12), hi, NEWTON_STEPS, ran);
  MARK(q++);
  x_out[i] = xi;
  if (steps != nullptr) {
    steps[2 * i] = widened;
    steps[2 * i + 1] = ran;
  }
}

template <typename T, bool EXIT>
int launch(const void* v, const void* lam, int lam_stride, T lam_value, void* x, void* steps,
           long long n, void* stream) {
  if (n > 0) {
    const int threads = element_threads(n);
    prox_inv_pos<T, EXIT><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(lam), lam_stride, lam_value,
        static_cast<T*>(x), static_cast<int*>(steps), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define INV_POS_ENTRY(SUFFIX, T, EXIT)                                                      \
  int sum_inv_pos_prox_##SUFFIX(const void* v, const void* lam, int lam_stride, T lam_value, \
                                void* x, void* steps, long long n, void* stream) {          \
    return launch<T, EXIT>(v, lam, lam_stride, lam_value, x, steps, n, stream);             \
  }

INV_POS_ENTRY(f32, float, true)
INV_POS_ENTRY(f64, double, true)
INV_POS_ENTRY(full_f32, float, false)
INV_POS_ENTRY(full_f64, double, false)

#ifdef K10_STEP_MARKS
// Where the step marks go on the current device (nullptr: none).
int sum_inv_pos_set_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(step_marks, &marks, sizeof(marks));
}
#endif

}  // extern "C"
