// LOG_SUM_EXP per row: the prox (entry a) and the epigraph projection
// (entry b), each one launch over a batch of rows.
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/vector.py prox_log_sum_exp (with util.py
// newton_safeguarded, 25 steps, and solve_w_log_w, 30 steps, both
// lax.fori_loop) and newton_epi.py implicit_newton_epigraph (24 steps) into
// one device program per call.  The port's plain versions,
// epsilon_tpu_torch/ops/prox/vector.py prox_log_sum_exp_reference and
// newton_epi.py epi_log_sum_exp_reference, issue every step of those loops
// as eager operations: 8,400 a prox of mnist's rows, 208,000 an epigraph of
// max_softmax's.  Here one warp runs one row's loops to the end.
//
// (a) prox_{lam LSE}(v) = v - q, q_i = W(c0_i - nu), c0 = v + log lam - 1,
//     with nu the root of sum_i q_i = lam (safeguarded Newton, 25 steps,
//     each g a row sum of 30-step Lambert solves: 28 solves in a row).
// (b) the projection onto {(x, t): LSE(x) <= t}: Newton on the epigraph's
//     lam, 24 steps, each a prox (a) of the row, then the final prox; rows
//     with LSE(v) <= s pass through.
//
// Bound: the dependent chain of the steps taken.  A row reads n values and
// writes n.  Every loop stops once its state repeats (row_loops.cuh), which
// gives the full-count result bitwise, so the chain is the steps the row
// actually takes, far fewer than the counts above (PERF.md gives them at
// the phase-7 shapes; chip_smoke.py's phase 7a counts them through the
// steps array): of a log, a divide and five more dependent operations a
// Lambert step, a warp sum a pass, a few scalar operations a Newton step.
// Rows are independent and go to separate warps.
//
// Mapping: one warp per row, 4 rows a block; the prox of a row of up to 16
// (mnist's 10) takes a half-warp, two rows a warp and 8 a block
// (prox_rows2), so that fewer lanes idle and mnist's rows fit the card in
// one wave of warps (its launch bounds hold the f32 build to 10 resident
// blocks a SM); both layouts give the same bits and each half exits on its
// own (row_loops.cuh).  Lane j holds element j of a
// row of up to 32 in registers (v, and in (b) each prox's x, which the
// softmax and metric sums reread; the output row is written once, at the
// end), and elements j, j + 32, ... of a longer row in device memory ((b)
// then keeps x in the output row, each lane rereading only what it
// wrote).  The scalar loops (nu, lam) run in every
// lane on sums that are the same in every lane, so the warp never diverges
// there.  lam and s are read per row from device
// memory (stride 0 broadcasts a scalar tensor), or passed by value where
// the caller has a host number.
//
// Entries: lse_prox_rows_*, lse_epi_rows_* (the loops exit when their state
// repeats), lse_prox_rows_full_*, lse_epi_rows_full_* (every loop runs
// its full count: the reference the exit is checked against bitwise, and
// the A/B's other side) and lse_prox_rows_wide_* (the prox that exits, one
// row a warp at every width: the layout the half-warp replaced, its
// bitwise reference and A/B side); no dispatch calls the last three.
// lse_prox_rows_resident_warps gives the warps a SM holds of the kernel
// a prox launch picks.  20 kernels: prox and epigraph, f32 and f64, a row
// in registers (n <= 32) or in memory, with and without the exit, and the
// half-warp prox (f32 and f64, with and without the exit).  Plain C
// interface for ctypes; each returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int WARPS = 4;

// The prox's nu for one row of W lanes (every lane returns it).
template <typename T, int E, bool EXIT, int W = 32>
__device__ __forceinline__ T prox_nu(const Row<T, E>& v, int n, int lane, T lam,
                                     Steps& st, bool count) {
  const T loglam = t_log(lam);
  const T inf = T(1) / T(0);
  T mn = inf, mx = -inf;
  each<E>(n, lane, [&](int e, int i) {
    const T c0 = v.at(e, i) + loglam - T(1);
    mn = tmin(mn, c0);
    mx = tmax(mx, c0);
  });
  mn = warp_min<W>(mn);
  mx = warp_max<W>(mx);
  // torch.logsumexp: shift by the max, an infinite max by 0
  const T m = is_inf(mx) ? T(0) : mx;
  T se = 0;
  each<E>(n, lane, [&](int e, int i) { se += t_exp(v.at(e, i) + loglam - T(1) - m); });
  const T lse_c0 = t_log(warp_sum<W>(se)) + m;
  const T lo = mn - lam / T(n) - t_log(lam / T(n));
  const T hi = lse_c0 - loglam + T(1);
  const T nu0 = tmin(tmax(lse_c0 - loglam, lo), hi);
  bool first = true;   // g(lo), off the chain (see Steps)
  bool live = true;    // false in a half cycling on after its repeat (W = 16)
  auto g = [&](T nu, T& gp) {
    T sq = 0, sqq = 0;
    int ran = 0;
    each<E>(n, lane, [&](int e, int i) {
      int k;
      const T q = solve_w_log_w<EXIT>(v.at(e, i) + loglam - T(1) - nu, k);
      ran += k;
      sq += q;
      sqq += q / (T(1) + q);
    });
    if (count) st.pass<W>(live ? ran : 0, !first && live);
    first = false;
    warp_sum2<W>(sqq, sq);
    gp = sqq;
    return lam - sq;
  };
  return newton_safeguarded<T, EXIT, W>(g, nu0, lo, hi, 25, &st.nu, &live);
}

// x = prox_{lam LSE}(v) into x.
template <typename T, int E, bool EXIT, int W = 32, typename X>
__device__ __forceinline__ void prox_row(const Row<T, E>& v, X& x, int n, int lane, T lam,
                                         Steps& st, bool count) {
  const T nu = prox_nu<T, E, EXIT, W>(v, n, lane, lam, st, count);
  const T loglam = t_log(lam);
  int ran = 0;
  each<E>(n, lane, [&](int e, int i) {
    int k;
    x.put(e, i, v.at(e, i) - solve_w_log_w<EXIT>(v.at(e, i) + loglam - T(1) - nu, k));
    ran += k;
  });
  if (count) st.pass<W>(ran, true);
}

// torch.logsumexp of a row.
template <int E, typename X>
__device__ __forceinline__ auto lse_row(const X& x, int n, int lane) {
  using T = std::remove_cv_t<std::remove_reference_t<decltype(x.at(0, 0))>>;
  T mx = -(T(1) / T(0));
  each<E>(n, lane, [&](int e, int i) { mx = tmax(mx, x.at(e, i)); });
  mx = warp_max(mx);
  const T m = is_inf(mx) ? T(0) : mx;
  T se = 0;
  each<E>(n, lane, [&](int e, int i) { se += t_exp(x.at(e, i) - m); });
  return t_log(warp_sum(se)) + m;
}

template <typename T, int E, bool EXIT>
__global__ void __launch_bounds__(32 * WARPS)
prox_rows(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
          T* __restrict__ x, int* __restrict__ steps, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long off = (long long)row * n;
  Row<T, E> vr;
  vr.load(v + off, n, lane);
  Row<T, 0> xr{x + off};   // written once
  Steps st;
  prox_row<T, E, EXIT>(vr, xr, n, lane, row_scalar(lam_p, lam_stride, lam_value, row), st,
                       steps != nullptr);
  if (steps != nullptr && lane == 0) st.write(steps, row);
}

// Blocks a SM must hold of the half-warp prox (a register budget for the
// compiler): in f32, 10 blocks of 4 warps, so that mnist's 5,000 warps fit
// the H100's 132 SMs at once.
template <typename T> constexpr int half_min_blocks() { return sizeof(T) == 4 ? 10 : 5; }

// Two rows of up to 16 a warp, lanes 0-15 and 16-31, in registers.
template <typename T, bool EXIT>
__global__ void __launch_bounds__(32 * WARPS, half_min_blocks<T>())
prox_rows2(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
           T* __restrict__ x, int* __restrict__ steps, int rows, int n) {
  const int first = 2 * (blockIdx.x * WARPS + threadIdx.x / 32);
  if (first >= rows) return;
  const int lane = threadIdx.x % 16;
  // past the last row, a half repeats the row before it (its shuffles must
  // run) and writes nothing
  const int own = first + (int)(threadIdx.x % 32) / 16;
  const bool ghost = own >= rows;
  const int row = ghost ? rows - 1 : own;
  const long long off = (long long)row * n;
  Row<T, 1> vr, xr;
  vr.load(v + off, n, lane);
  Steps st;
  prox_row<T, 1, EXIT, 16>(vr, xr, n, lane, row_scalar(lam_p, lam_stride, lam_value, row), st,
                           steps != nullptr);
  if (!ghost) {
    xr.store(x + off, n, lane);
    if (steps != nullptr && lane == 0) st.write(steps, row);
  }
}

template <typename T, int E, bool EXIT>
__global__ void __launch_bounds__(32 * WARPS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* x, T* __restrict__ t, int* __restrict__ steps, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long off = (long long)row * n;
  const bool count = steps != nullptr;
  Row<T, E> vr;
  vr.load(v + off, n, lane);
  T* xout = x + off;
  Steps st;
  const T s = row_scalar(s_p, s_stride, s_value, row);
  if (lse_row<E>(vr, n, lane) <= s) {   // inactive: (v, s) is in the epigraph
    vr.store(xout, n, lane);
    if (lane == 0) {
      t[row] = s;
      if (count) st.write(steps, row);
    }
    return;
  }
  // each prox's x: registers, or the output row where v stays in memory
  Row<T, E> xr;
  if constexpr (E == 0) xr.p = xout;
  // h(lam) = LSE(prox(v, lam)) - s - lam, h' = -g'M^{-1}g - 1 with
  // g = softmax(x) and newton_epi.lse_metric_solve's Sherman-Morrison form
  auto h = [&](T lam, T& hp) {
    prox_row<T, E, EXIT>(vr, xr, n, lane, lam, st, count);
    T mx = -(T(1) / T(0));
    each<E>(n, lane, [&](int e, int i) { mx = tmax(mx, xr.at(e, i)); });
    mx = warp_max(mx);
    T se = 0;
    each<E>(n, lane, [&](int e, int i) { se += t_exp(xr.at(e, i) - mx); });
    se = warp_sum(se);
    const T m = is_inf(mx) ? T(0) : mx;
    T se_lse = se;
    if (m != mx) {
      se_lse = 0;
      each<E>(n, lane, [&](int e, int i) { se_lse += t_exp(xr.at(e, i) - m); });
      se_lse = warp_sum(se_lse);
    }
    const T f = t_log(se_lse) + m;
    T denom = 0, pdr = 0;
    each<E>(n, lane, [&](int e, int i) {
      const T p = t_exp(xr.at(e, i) - mx) / se;
      const T d = T(1) + lam * p;
      const T dr = p / d;
      denom += dr;
      pdr += p * dr;
    });
    warp_sum2(denom, pdr);
    T gmg = 0;
    each<E>(n, lane, [&](int e, int i) {
      const T p = t_exp(xr.at(e, i) - mx) / se;
      const T d = T(1) + lam * p;
      const T dr = p / d;
      gmg += p * (dr + lam * dr * pdr / denom);
    });
    hp = -warp_sum(gmg) - T(1);
    return f - s - lam;
  };
  const T lam = implicit_newton_lam<T, EXIT>(h, 24, st.lam);
  prox_row<T, E, EXIT>(vr, xr, n, lane, lam, st, count);
  const T f = lse_row<E>(xr, n, lane);
  xr.store(xout, n, lane);
  if (lane == 0) {
    t[row] = s + tmax(f - s, lam);
    if (count) st.write(steps, row);
  }
}

// The prox kernel for rows of n: the half-warp one for n <= 16 unless
// `wide`, else one row a warp.  f(kernel, rows a block).
template <typename T, bool EXIT, typename F>
void prox_kernel(int n, bool wide, F f) {
  if (!wide && n <= 16) return f(prox_rows2<T, EXIT>, 2 * WARPS);
  by_width(n, [&](auto width) { f(prox_rows<T, decltype(width)::value, EXIT>, WARPS); });
}

template <typename T, bool EXIT>
int launch_prox(const void* v, const void* lam, int lam_stride, T lam_value, void* x,
                void* steps, int rows, int n, bool wide, void* stream) {
  if (rows > 0) {
    prox_kernel<T, EXIT>(n, wide, [&](auto kernel, int per_block) {
      kernel<<<(rows + per_block - 1) / per_block, 32 * WARPS, 0,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(v), static_cast<const T*>(lam), lam_stride, lam_value,
          static_cast<T*>(x), static_cast<int*>(steps), rows, n);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int resident_warps(int n, bool wide, int* warps) {
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  prox_kernel<T, true>(n, wide, [&](auto kernel, int) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * WARPS, 0);
  });
  *warps = blocks * WARPS;
  return (int)err;
}

template <typename T, bool EXIT>
int launch_epi(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
               void* steps, int rows, int n, void* stream) {
  if (rows > 0) {
    by_width(n, [&](auto width) {
      epi_rows<T, decltype(width)::value, EXIT>
          <<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
              static_cast<T*>(x), static_cast<T*>(t), static_cast<int*>(steps), rows, n);
    });
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define LSE_PROX_ENTRY(SUFFIX, T, EXIT, WIDE)                                               \
  int lse_prox_rows_##SUFFIX(const void* v, const void* lam, int lam_stride, T lam_value,   \
                             void* x, void* steps, int rows, int n, void* stream) {        \
    return launch_prox<T, EXIT>(v, lam, lam_stride, lam_value, x, steps, rows, n, WIDE,    \
                                stream);                                                    \
  }

#define LSE_ENTRIES(SUFFIX, T, EXIT)                                                        \
  LSE_PROX_ENTRY(SUFFIX, T, EXIT, false)                                                    \
  int lse_epi_rows_##SUFFIX(const void* v, const void* s, int s_stride, T s_value,         \
                            void* x, void* t, void* steps, int rows, int n, void* stream) { \
    return launch_epi<T, EXIT>(v, s, s_stride, s_value, x, t, steps, rows, n, stream);     \
  }

LSE_ENTRIES(f32, float, true)
LSE_ENTRIES(f64, double, true)
LSE_ENTRIES(full_f32, float, false)
LSE_ENTRIES(full_f64, double, false)
LSE_PROX_ENTRY(wide_f32, float, true, true)
LSE_PROX_ENTRY(wide_f64, double, true, true)

// Warps a SM holds of the kernel that lse_prox_rows_* (or, with wide,
// lse_prox_rows_wide_*) launches on rows of n, f32 or f64.
int lse_prox_rows_resident_warps(int f64, int n, int wide, int* warps) {
  return f64 ? resident_warps<double>(n, wide != 0, warps)
             : resident_warps<float>(n, wide != 0, warps);
}

}  // extern "C"
