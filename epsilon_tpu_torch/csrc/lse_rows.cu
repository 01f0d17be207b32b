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
// Bound: the dependent chain.  A row reads n values and writes n, while
// (b) runs 25 x 27 dependent Lambert solves of 30 Newton steps each
// (20,250 steps of a log, a divide and five more dependent operations);
// rows are independent and go to separate warps.
//
// Mapping: one warp per row, 4 rows a block; lane j holds elements j,
// j + 32, ...  The scalar loops (nu, lam) run in every lane on sums that are
// the same in every lane, so the warp never diverges.  (b) keeps each
// prox's x in the output row (each lane rereads only what it wrote) as
// the scratch for the softmax and metric sums.  lam and s are read per
// row from device memory (stride 0 broadcasts a scalar tensor), or passed
// by value where the caller has a host number.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include "row_loops.cuh"

namespace {

using namespace rowloops;

constexpr int WARPS = 4;

// The prox's nu for one row (every lane returns it).
template <typename T>
__device__ T prox_nu(const T* v, int n, int lane, T lam) {
  const T loglam = t_log(lam);
  const T inf = T(1) / T(0);
  T mn = inf, mx = -inf;
  for (int i = lane; i < n; i += 32) {
    const T c0 = v[i] + loglam - T(1);
    mn = tmin(mn, c0);
    mx = tmax(mx, c0);
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  // torch.logsumexp: shift by the max, an infinite max by 0
  const T m = is_inf(mx) ? T(0) : mx;
  T se = 0;
  for (int i = lane; i < n; i += 32) se += t_exp(v[i] + loglam - T(1) - m);
  const T lse_c0 = t_log(warp_sum(se)) + m;
  const T lo = mn - lam / T(n) - t_log(lam / T(n));
  const T hi = lse_c0 - loglam + T(1);
  const T nu0 = tmin(tmax(lse_c0 - loglam, lo), hi);
  auto g = [&](T nu, T& gp) {
    T sq = 0, sqq = 0;
    for (int i = lane; i < n; i += 32) {
      const T q = solve_w_log_w(v[i] + loglam - T(1) - nu);
      sq += q;
      sqq += q / (T(1) + q);
    }
    gp = warp_sum(sqq);
    return lam - warp_sum(sq);
  };
  return newton_safeguarded<T>(g, nu0, lo, hi, 25);
}

// x = prox_{lam LSE}(v) into x (lane-strided).
template <typename T>
__device__ void prox_row(const T* v, T* x, int n, int lane, T lam) {
  const T nu = prox_nu(v, n, lane, lam);
  const T loglam = t_log(lam);
  for (int i = lane; i < n; i += 32) x[i] = v[i] - solve_w_log_w(v[i] + loglam - T(1) - nu);
}

// torch.logsumexp of a row.
template <typename T>
__device__ T lse_row(const T* x, int n, int lane) {
  T mx = -(T(1) / T(0));
  for (int i = lane; i < n; i += 32) mx = tmax(mx, x[i]);
  mx = warp_max(mx);
  const T m = is_inf(mx) ? T(0) : mx;
  T se = 0;
  for (int i = lane; i < n; i += 32) se += t_exp(x[i] - m);
  return t_log(warp_sum(se)) + m;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
prox_rows(const T* __restrict__ v, const T* lam_p, int lam_stride, T lam_value,
          T* __restrict__ x, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long off = (long long)row * n;
  prox_row(v + off, x + off, n, lane, row_scalar(lam_p, lam_stride, lam_value, row));
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
epi_rows(const T* __restrict__ v, const T* s_p, int s_stride, T s_value,
         T* x, T* __restrict__ t, int rows, int n) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long off = (long long)row * n;
  const T* vr = v + off;
  T* xr = x + off;
  const T s = row_scalar(s_p, s_stride, s_value, row);
  if (lse_row(vr, n, lane) <= s) {   // inactive: (v, s) is in the epigraph
    for (int i = lane; i < n; i += 32) xr[i] = vr[i];
    if (lane == 0) t[row] = s;
    return;
  }
  // h(lam) = LSE(prox(v, lam)) - s - lam, h' = -g'M^{-1}g - 1 with
  // g = softmax(x) and newton_epi.lse_metric_solve's Sherman-Morrison form
  auto h = [&](T lam, T& hp) {
    prox_row(vr, xr, n, lane, lam);
    T mx = -(T(1) / T(0));
    for (int i = lane; i < n; i += 32) mx = tmax(mx, xr[i]);
    mx = warp_max(mx);
    T se = 0;
    for (int i = lane; i < n; i += 32) se += t_exp(xr[i] - mx);
    se = warp_sum(se);
    const T m = is_inf(mx) ? T(0) : mx;
    T se_lse = se;
    if (m != mx) {
      se_lse = 0;
      for (int i = lane; i < n; i += 32) se_lse += t_exp(xr[i] - m);
      se_lse = warp_sum(se_lse);
    }
    const T f = t_log(se_lse) + m;
    T denom = 0, pdr = 0;
    for (int i = lane; i < n; i += 32) {
      const T p = t_exp(xr[i] - mx) / se;
      const T d = T(1) + lam * p;
      const T dr = p / d;
      denom += dr;
      pdr += p * dr;
    }
    denom = warp_sum(denom);
    pdr = warp_sum(pdr);
    T gmg = 0;
    for (int i = lane; i < n; i += 32) {
      const T p = t_exp(xr[i] - mx) / se;
      const T d = T(1) + lam * p;
      const T dr = p / d;
      gmg += p * (dr + lam * dr * pdr / denom);
    }
    hp = -warp_sum(gmg) - T(1);
    return f - s - lam;
  };
  const T lam = implicit_newton_lam<T>(h, 24);
  prox_row(vr, xr, n, lane, lam);
  const T f = lse_row(xr, n, lane);
  if (lane == 0) t[row] = s + tmax(f - s, lam);
}

template <typename T>
int launch_prox(const void* v, const void* lam, int lam_stride, T lam_value, void* x,
                int rows, int n, void* stream) {
  if (rows > 0) {
    prox_rows<T><<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(lam), lam_stride, lam_value,
        static_cast<T*>(x), rows, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_epi(const void* v, const void* s, int s_stride, T s_value, void* x, void* t,
               int rows, int n, void* stream) {
  if (rows > 0) {
    epi_rows<T><<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(s), s_stride, s_value,
        static_cast<T*>(x), static_cast<T*>(t), rows, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lse_prox_rows_f32(const void* v, const void* lam, int lam_stride, float lam_value,
                      void* x, int rows, int n, void* stream) {
  return launch_prox<float>(v, lam, lam_stride, lam_value, x, rows, n, stream);
}

int lse_prox_rows_f64(const void* v, const void* lam, int lam_stride, double lam_value,
                      void* x, int rows, int n, void* stream) {
  return launch_prox<double>(v, lam, lam_stride, lam_value, x, rows, n, stream);
}

int lse_epi_rows_f32(const void* v, const void* s, int s_stride, float s_value, void* x,
                     void* t, int rows, int n, void* stream) {
  return launch_epi<float>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

int lse_epi_rows_f64(const void* v, const void* s, int s_stride, double s_value, void* x,
                     void* t, int rows, int n, void* stream) {
  return launch_epi<double>(v, s, s_stride, s_value, x, t, rows, n, stream);
}

}  // extern "C"
