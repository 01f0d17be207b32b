// Device helpers shared by the per-row loop kernels (lse_rows.cu,
// epi_sum_square.cu, epi_neg_log.cu), the one-thread-an-element loop
// kernels (sum_logistic.cu, epi_exp.cu, sum_kl_div.cu, sum_inv_pos.cu,
// w_log_w.cu: iterate4(), newton_element(), widen(), element_threads())
// and launch_floor.cu's chains.
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
//
// The exit.  Each loop is a fixed map of its state: the Lambert solve's w
// (c fixed), the safeguarded Newton's (x, lo, hi, glo, ghi) and the
// epigraph Newton's (lam, lo, hi) (g and h depend on x and lam alone).
// Built with EXIT, a loop keeps its last four states and compares each new
// one with them bitwise; once the state after step k equals the state after
// step k - p (p <= 4), the sequence is periodic from there, so the state
// after all N steps is the state after step k - p + ((N - k) mod p), which
// the loop returns at once (iterate() below).  That is exactly the
// full-count result: the same operations on the same bits give the same
// bits, NaN states included.  Without EXIT (the full-count builds, the
// A/B's reference) every loop runs its count.  The Lambert solve exits per
// lane (the lanes meet again at the pass's warp sum, whose full-mask
// shuffles wait for every lane); the Newton loops run on sums that are the
// same in every lane, so their exit is the same in every lane.
//
// Rows in registers.  A row of n <= 32 elements, the main path's widths, is
// loaded once into registers, lane j holding element j, and every pass
// reads it there (Row<T, 1>); a longer row stays in device memory and each
// pass reads it lane-strided (Row<T, 0>).  Both take the elements in the
// same order, so the sums are the same.
//
// Two rows a warp.  A row of n <= 16 (the LOG_SUM_EXP prox at mnist's
// width of 10) can take a half-warp: lanes 0-15 hold one row, lanes 16-31
// the next, and every butterfly runs at width W = 16 (offsets 8, 4, 2, 1,
// which stay inside the half).  The one-row-a-warp butterfly of such a row
// adds only identities in its first level (+0 to a partial sum that began
// as +0, so never -0; -inf to a max, +inf to a min) and is the 16-wide one
// after that, so both give the same bits.  Each half keeps its own exit:
// the warp runs a loop while either half still steps and every shuffle
// stays full-mask; a half whose state has repeated steps on through its
// cycle, uncounted, and at the loop's end returns the state of that cycle
// that the full count reaches (iterate(); tests/test_torch_loop_exit.py
// holds the rule on the plain loops).

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <type_traits>

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
__device__ __forceinline__ float t_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double t_pow(double x, double y) { return pow(x, y); }

// The port's plain cube root (ops/prox/elementwise.py _cbrt,
// sign(x) * |x| ** (1/3)) as torch computes it on the card: torch.sign is
// (0 < x) - (x < 0) in the element type (0 for NaN and +-0), and
// torch.pow with a Python-float exponent takes the exponent in the
// element type (1/3 rounded to float in f32) and calls pow.  Not cbrtf,
// which rounds otherwise.
template <typename T> __device__ __forceinline__ T torch_cbrt(T x) {
  const T sign = T((T(0) < x) - (x < T(0)));
  return sign * t_pow(fabs(x), T(1.0 / 3.0));
}

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

// Butterflies over a segment of W lanes (W = 32: the warp; W = 16: its
// half); every lane of the segment ends with the same bits.
template <int W = 32, typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// Two independent sums through one butterfly (each the same as warp_sum's).
template <int W = 32, typename T> __device__ __forceinline__ void warp_sum2(T& a, T& b) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const T oa = __shfl_xor_sync(0xffffffffu, a, off);
    const T ob = __shfl_xor_sync(0xffffffffu, b, off);
    a += oa;
    b += ob;
  }
}
template <int W = 32, typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int W = 32, typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v = tmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ bool warp_all(bool p) { return __all_sync(0xffffffffu, p); }

// -- the exit -------------------------------------------------------------

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// The last four states of a loop, newest first (a shift through fixed
// slots: no dynamic indexing, so they stay in registers).
template <typename S> struct Ring4 {
  S s1, s2, s3, s4;
  __device__ __forceinline__ explicit Ring4(const S& s) : s1(s), s2(s), s3(s), s4(s) {}
  // The least p <= 4 whose state equals s, or 0.  Before step 4 the slots
  // not yet written hold the start, so they match only where a nearer one
  // does.
  __device__ __forceinline__ int period(const S& s) const {
    return same(s, s1) ? 1 : same(s, s2) ? 2 : same(s, s3) ? 3 : same(s, s4) ? 4 : 0;
  }
  __device__ __forceinline__ void push(const S& s) { s4 = s3; s3 = s2; s2 = s1; s1 = s; }
  // The state j = 1, 2, 3 or 4 steps back.
  __device__ __forceinline__ S back(int j) const {
    return j == 1 ? s1 : j == 2 ? s2 : j == 3 ? s3 : s4;
  }
};

// The state after `iters` steps of s = step(s); `ran` gets the steps run.
// With EXIT, the loop stops at the first state that repeats one of the
// last four (see the header).  W = 16: two rows a warp, each half with its
// own state (step() holds full-mask shuffles, so every lane calls it while
// either half steps).  A half whose state has repeated with period p steps
// on through that cycle until the other half's repeats too (or the count
// ends), uncounted (`*live`, where given, is false there), and returns the
// state of its cycle that the full count reaches.
//
// Two rules, because W = 32 serves loops that no vote may wait on: the
// Lambert solve runs per lane and only in the lanes that hold an element
// (each() skips the rest), so a full-mask __all_sync there would wait for
// lanes that never reach it.  Such a loop returns at its own first repeat;
// so does a loop on sums that every lane of the warp holds alike, where
// that repeat comes at the same step in every lane.  The vote is needed
// only where two rows share the warp's shuffles and exit apart (W < 32).
template <bool EXIT, int W = 32, typename S, typename F>
__device__ __forceinline__ S iterate(S s, int iters, F step, int& ran, bool* live = nullptr) {
  if constexpr (EXIT && W < 32) {
    Ring4<S> ring(s);
    int period = 0, k = 0;
    ran = iters;
#pragma unroll 1
    while (k < iters) {
      s = step(s);
      ++k;
      if (period == 0) {
        period = ring.period(s);
        if (period != 0) {
          ran = k;
          if (live != nullptr) *live = false;
        }
      }
      ring.push(s);
      if (__all_sync(0xffffffffu, period != 0)) break;
    }
    if (live != nullptr) *live = true;
    // the ring holds the states k, k - 1, k - 2, k - 3; the full count's
    // is the state k - p + ((iters - k) mod p) of the cycle
    const int r = period == 0 ? 0 : (iters - k) % period;
    return r == 0 ? s : ring.back(period - r + 1);
  } else if constexpr (EXIT) {
    Ring4<S> ring(s);
#pragma unroll 1
    for (int k = 1; k <= iters; ++k) {
      s = step(s);
      const int p = ring.period(s);
      if (p != 0) {
        ran = k;
        const int r = (iters - k) % p;
        return r == 0 ? s : ring.back(p - r);
      }
      ring.push(s);
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < iters; ++k) s = step(s);
  }
  ran = iters;
  return s;
}

// -- rows -----------------------------------------------------------------

// One row as lane `lane` sees it: E > 0, its elements i = lane + 32 e
// (e < E, i < n) in registers; E == 0, the row in device memory.
template <typename T, int E> struct Row {
  T a[E];
  __device__ __forceinline__ void load(const T* p, int n, int lane) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < n) a[e] = p[lane + 32 * e];
  }
  __device__ __forceinline__ T at(int e, int) const { return a[e]; }
  __device__ __forceinline__ void put(int e, int, T x) { a[e] = x; }
  __device__ __forceinline__ void store(T* p, int n, int lane) const {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < n) p[lane + 32 * e] = a[e];
  }
};
template <typename T> struct Row<T, 0> {
  T* p;
  __device__ __forceinline__ void load(const T* q, int, int) { p = const_cast<T*>(q); }
  __device__ __forceinline__ T at(int, int i) const { return p[i]; }
  __device__ __forceinline__ void put(int, int i, T x) { p[i] = x; }
  __device__ __forceinline__ void store(T* q, int n, int lane) const {
    if (q != p)
      for (int i = lane; i < n; i += 32) q[i] = p[i];
  }
};

// f(e, i) for each of the lane's elements, in the order of i.
template <int E, typename F>
__device__ __forceinline__ void each(int n, int lane, F f) {
  if constexpr (E > 0) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < n) f(e, lane + 32 * e);
  } else {
    for (int i = lane; i < n; i += 32) f(0, i);
  }
}

// f(std::integral_constant<int, E>): E = 1 for a row of up to 32 elements,
// held in registers, else E = 0.
template <typename F> void by_width(int n, F f) {
  if (n <= 32) return f(std::integral_constant<int, 1>{});
  f(std::integral_constant<int, 0>{});
}

// Per-row step counts for the chain bound, written where the caller passed
// a steps array (nullptr on the main path): [0] epigraph Newton steps on
// lam, [1] safeguarded Newton steps on nu (summed over the row's proxes),
// [2] Lambert steps on the warp's chain (per pass, the most any lane ran;
// summed over the passes but the bracket's lower end, which is independent
// of the upper), [3] Lambert steps of all elements (summed over every pass).
// K4 puts its safeguarded Newton steps on lam in [0] and its widening
// steps in [1].  W: the lanes of the row (see warp_sum).
struct Steps {
  int lam = 0, nu = 0, warp = 0, elem = 0;
  template <int W = 32>
  __device__ __forceinline__ void pass(int lane_steps, bool chain) {
    if constexpr (W == 32) {
      if (chain) warp += (int)__reduce_max_sync(0xffffffffu, (unsigned)lane_steps);
      elem += (int)__reduce_add_sync(0xffffffffu, (unsigned)lane_steps);
    } else {
      int most = lane_steps, all = lane_steps;
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1) {
        most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
        all += __shfl_xor_sync(0xffffffffu, all, off);
      }
      if (chain) warp += most;
      elem += all;
    }
  }
  __device__ __forceinline__ void write(int* p, int row) const {
    int* q = p + 4LL * row;
    q[0] = lam; q[1] = nu; q[2] = warp; q[3] = elem;
  }
};

// -- the loops ------------------------------------------------------------

// util.solve_w_log_w: w + log w = c for w > 0, 30 Newton steps; `ran`
// gets the steps run.
template <bool EXIT, typename T> __device__ __forceinline__ T solve_w_log_w(T c, int& ran) {
  const T tiny = Lim<T>::tiny();
  T w = c > T(1) ? c - t_log(clamp_min(c, T(1.1))) : t_exp(clamp_max(c, T(1)));
  w = clamp_min(w, tiny);
  return iterate<EXIT>(w, 30, [&](T u) {
    return clamp_min(u - (u + t_log(u) - c) * u / (u + T(1)), tiny);
  }, ran);
}

// util.newton_safeguarded's state.
template <typename T> struct Bracket { T x, lo, hi, glo, ghi; };
template <typename T> __device__ __forceinline__ bool same(const Bracket<T>& a, const Bracket<T>& b) {
  return same(a.x, b.x) && same(a.lo, b.lo) && same(a.hi, b.hi) && same(a.glo, b.glo) &&
         same(a.ghi, b.ghi);
}

// util.newton_safeguarded for non-decreasing g: Newton kept inside a
// bracket with endpoint residuals, Illinois regula falsi as the fallback.
// gfun(x, gp) returns g(x) and sets gp = g'(x); a warp calls it together
// when g reduces over a row.  The state is not a plain bracket that only
// shrinks: once x settles between two neighbouring floats at the root, the
// step swaps glo and ghi's roles and the Illinois halving undoes itself, so
// the state repeats with period 2-4 (tests/test_torch_loop_exit.py), on
// the LOG_SUM_EXP prox's nu and on K4's cubic alike, and both exit there
// (EXIT).  W and live: see iterate().
template <typename T, bool EXIT = false, int W = 32, typename G>
__device__ __forceinline__ T newton_safeguarded(G gfun, T x, T lo, T hi, int iters,
                                                int* ran = nullptr, bool* live = nullptr) {
  T gp;
  const T glo = gfun(lo, gp);
  const T ghi = gfun(hi, gp);
  int k;
  const Bracket<T> b = iterate<EXIT, W>(Bracket<T>{x, lo, hi, glo, ghi}, iters,
                                     [&](Bracket<T> b) {
    T gpx;
    const T gx = gfun(b.x, gpx);
    if (gx < T(0)) {
      b.lo = tmax(b.lo, b.x);
      b.glo = gx;
      b.ghi = T(0.5) * b.ghi;
    } else {
      b.hi = tmin(b.hi, b.x);
      b.ghi = gx;
      b.glo = T(0.5) * b.glo;
    }
    const T step = gpx != T(0) ? gx / gpx : T(0);
    const T xn = b.x - step;
    const T denom = b.ghi - b.glo;
    const T mid = T(0.5) * (b.lo + b.hi);
    T falsi = denom != T(0) ? (b.lo * b.ghi - b.hi * b.glo) / denom : mid;
    falsi = is_finite(falsi) ? tmin(tmax(falsi, b.lo), b.hi) : mid;
    const bool bad = xn <= b.lo || xn >= b.hi || !is_finite(xn);
    b.x = bad ? falsi : xn;
    return b;
  }, k, live);
  if (ran != nullptr) *ran += k;
  return b.x;
}

// -- one thread an element (K6 sum_logistic.cu, K8 epi_exp.cu, K9 ---------
// -- sum_kl_div.cu, K10 sum_inv_pos.cu, K11 w_log_w.cu) -------------------
//
// The lanes of these loops are independent (no shuffles), so each exits
// alone, and a warp runs at the pace of its slowest lane: the exit pays
// where it is checked.  The rule stays iterate()'s: once the state after
// step k equals the state after step k - p (p <= 4), the state after all N
// steps is the state of that cycle which step N reaches, and finding the
// repeat at a later step changes nothing.  So iterate4() runs four steps
// at a time, the states named s0 (before them) .. s4 (rotated by their
// names at compile time, not by moves), and compares s4 with s3, s2, s1,
// s0 once, x first: the other fields only where an x matches.  Where none
// repeats by the last whole four, the rest of the count runs after the
// body; no check follows the last step, whose state is the result whatever
// a check would find.  `ran` gets the steps run (a multiple of 4 at an
// exit).  Without EXIT every step of the count runs.  K9's and K10's Newton
// runs without it: at their launches nearly every warp holds a lane that
// runs the count, and the checks cost more than the steps they save
// (tools/profile_port.py --k9, --k10); K6 and K8 keep it.
template <bool EXIT, typename T, typename F>
__device__ __forceinline__ Bracket<T> iterate4(Bracket<T> s, int iters, F step, int& ran) {
  if constexpr (EXIT) {
    int k = 0;
#pragma unroll 1
    for (; k + 4 <= iters; k += 4) {
      const Bracket<T> s0 = s;
      const Bracket<T> s1 = step(s0);
      const Bracket<T> s2 = step(s1);
      const Bracket<T> s3 = step(s2);
      s = step(s3);
      if (same(s.x, s3.x) || same(s.x, s2.x) || same(s.x, s1.x) || same(s.x, s0.x)) {
        const int p = same(s, s3) ? 1 : same(s, s2) ? 2 : same(s, s1) ? 3 : same(s, s0) ? 4 : 0;
        if (p != 0) {
          ran = k + 4;
          // the full count's state: step k + 4 + r of the cycle, r =
          // (iters - k - 4) mod p, which is the state 4 + r - p of the slots
          const int slot = 4 + (iters - k - 4) % p - p;
          return slot == 0 ? s0 : slot == 1 ? s1 : slot == 2 ? s2 : slot == 3 ? s3 : s;
        }
      }
    }
#pragma unroll 1
    for (; k < iters; ++k) s = step(s);
  } else {
#pragma unroll 1
    for (int k = 0; k < iters; ++k) s = step(s);
  }
  ran = iters;
  return s;
}

// util.newton_safeguarded for one element a thread, on iterate4(): the
// same operations in the same order as newton_safeguarded() above, with
// the bracket's update and the Newton step as selects.  gfun(x, gp) as for
// newton_safeguarded(); `ran` gets the steps run.
template <typename T, bool EXIT, typename G>
__device__ __forceinline__ T newton_element(G gfun, T x, T lo, T hi, int iters, int& ran) {
  T gp;
  const T glo = gfun(lo, gp);
  const T ghi = gfun(hi, gp);
  return iterate4<EXIT>(Bracket<T>{x, lo, hi, glo, ghi}, iters, [&](Bracket<T> b) {
    T gpx;
    const T gx = gfun(b.x, gpx);
    const bool neg = gx < T(0);
    b.lo = neg ? tmax(b.lo, b.x) : b.lo;
    b.hi = neg ? b.hi : tmin(b.hi, b.x);
    const T glo_n = neg ? gx : T(0.5) * b.glo;
    b.ghi = neg ? T(0.5) * b.ghi : gx;
    b.glo = glo_n;
    // each quotient and clamp taken whatever its guard says and then
    // selected: no branch around them on the step's chain, the same bits
    const T quotient = gx / gpx;
    const T step = gpx != T(0) ? quotient : T(0);
    const T xn = b.x - step;
    const T denom = b.ghi - b.glo;
    const T mid = T(0.5) * (b.lo + b.hi);
    const T ratio = (b.lo * b.ghi - b.hi * b.glo) / denom;
    const T falsi = denom != T(0) ? ratio : mid;
    const T clamped = tmin(tmax(falsi, b.lo), b.hi);
    const T fallback = is_finite(falsi) ? clamped : mid;
    const bool bad = xn <= b.lo || xn >= b.hi || !is_finite(xn);
    b.x = bad ? fallback : xn;
    return b;
  }, ran).x;
}

// A widening of one bracket end, b = step(b) `iters` times (K8's lower
// end, K9's and K10's upper end: a doubling where g says the root lies
// beyond).  The step is a fixed map of b alone (the element's data held),
// so once a step leaves b unchanged, bitwise, every later step does too
// (period 1): with EXIT the loop stops there, which is the full count's
// b.  `ran` gets the steps run (the first that left b unchanged
// included).  Without EXIT every step of the count runs.
template <bool EXIT, typename T, typename F>
__device__ __forceinline__ T widen(T b, int iters, F step, int& ran) {
  ran = iters;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const T next = step(b);
    if (EXIT && same(next, b)) {
      ran = k + 1;
      break;
    }
    b = next;
  }
  return b;
}

// The threads a block of a one-thread-an-element launch of n (K6, K8-K11):
// enough warps a block to spread n over every SM of the current device,
// at least one warp and at most 256 threads.  A small launch (logreg_l1's
// 1,500 elements) then takes one-warp blocks on 47 SMs, one warp to a
// scheduler, where 256-thread blocks would put 8 warps on each of 6 SMs.
// Elements are independent, so the mapping changes no bit.
inline int element_threads(long long n) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = count > 0 ? count : 1;
  }
  const long long per_sm = (n + sms[dev] - 1) / sms[dev];
  const long long threads = 32 * ((per_sm + 31) / 32);
  return (int)(threads < 32 ? 32 : threads > 256 ? 256 : threads);
}

// newton_epi.implicit_newton_epigraph's state.
template <typename T> struct LamState { T lam, lo, hi; };
template <typename T> __device__ __forceinline__ bool same(const LamState<T>& a, const LamState<T>& b) {
  return same(a.lam, b.lam) && same(a.lo, b.lo) && same(a.hi, b.hi);
}

// newton_epi.implicit_newton_epigraph's loop on lam (the port's strict
// bracket test), `iters` steps from lam = 1; `ran` gets the steps run.
// hfun(lam, hp) returns h(lam) = f(prox(v, lam)) - s - lam and sets
// hp = h'(lam).
template <typename T, bool EXIT, typename H>
__device__ __forceinline__ T implicit_newton_lam(H hfun, int iters, int& ran) {
  const T big = Lim<T>::max() / T(4);
  const LamState<T> start{T(1), Lim<T>::domain_eps(), big * T(2)};
  return iterate<EXIT>(start, iters, [&](LamState<T> st) {
    T hp;
    const T h = hfun(st.lam, hp);
    if (h > T(0)) st.lo = tmax(st.lo, st.lam);
    if (h <= T(0)) st.hi = tmin(st.hi, st.lam);
    const T lam_n = st.lam - h / hp;
    const T fallback = st.hi >= big ? clamp_min(T(4) * st.lam, T(1)) : T(0.5) * (st.lo + st.hi);
    const bool bad = lam_n < st.lo || lam_n > st.hi || !is_finite(lam_n);
    st.lam = bad ? fallback : lam_n;
    return st;
  }, ran).lam;
}

// A per-row scalar: from device memory (stride 0 broadcasts one value) or,
// where the caller passed a host number, by value.
template <typename T>
__device__ __forceinline__ T row_scalar(const T* p, int stride, T value, int row) {
  return p == nullptr ? value : p[(long long)row * stride];
}

}  // namespace rowloops
