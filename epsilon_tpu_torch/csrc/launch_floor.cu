// Empty kernels: what one launch through the per-row kernels' ctypes path
// (ops/kernels/_rows.py) costs with no work, the floor that chip_smoke.py's
// phase 7a prints beside each per-row kernel's bound; and an empty
// cooperative kernel that only waits at k grid syncs, at the grid a
// cooperative kernel takes (the TV-1D PDAS, tv1d_pdas.cu), which gives what
// one grid.sync() costs on the card.  No dispatch calls them.
//
// The chains: one thread an element, each running the dependent chain of
// a one-thread-an-element loop kernel's steps and nothing else, launched
// as that kernel launches (row_loops.cuh element_threads()): the least
// time the kernel could take for the steps its elements run, launch
// included, which chip_smoke.py's phase 7a prints as the kernel's bound.
// k6_chain: `steps` Newton steps of K6 (sum_logistic.cu): the sigmoid (an
// exp and an IEEE division), g and g', the IEEE division g / g' and x -
// step; no bracket, no regula falsi, no exit.  epi_exp_chain: `widen`
// steps of K8's widening (epi_exp.cu: an exp, g and the select), the
// bracket's clamp (a log), then `newton` Newton steps (an exp, g and g',
// the division, x - step, and the step's select into the bracket as a
// clamp) and t = exp(x).  kl_div_chain: `widen` doublings of K9's upper
// end (sum_kl_div.cu: g, a log, and the select), then `newton` Newton
// steps (g and g', a log and two IEEE divisions, r - step and its clamp
// into the bracket), then y and x.  inv_pos_chain: K10's cube root
// (sum_inv_pos.cu: torch's sign and pow), `widen` doublings, `newton`
// Newton steps (g and g', the division, x - step and its clamp).
// w_log_w_chain: K11's argument c (w_log_w.cu: the SUM_EXP entry's log(lam)
// + v, or the SUM_NEG_ENTR entry's (v - lam) / lam - log(lam)), the start
// (a log or an exp, the clamp at tiny) and `steps` steps of the Lambert
// Newton (a log, the IEEE division, the clamp at tiny), then the entry's x
// (v - w, or lam w).  Each feeds its x back, so nothing is hoisted, and
// writes it out.  The source is built with the loop kernels' flags
// (--fmad=false).
//
// K9-K11's chains take lam by value, as the kernels take it at the timed
// shape, and read no more than their kernels: u (K9) and v, one element a
// thread, and x written.  Where `warp_steps` is given, each warp runs the
// steps of its slowest element in this run of the kernel (the work these
// inputs need: a warp of a one-thread-an-element kernel lasts as long as
// its slowest lane), one int a warp (K9, K10: the widening's steps in the
// low 16 bits, the Newton's in the high), 4 bytes for 32 elements; else
// every element runs the counts passed.
//
// cube_root: row_loops.cuh torch_cbrt() alone, the cube root K10 takes,
// for chip_smoke.py's check against the plain version's on the card.
//
// Plain C interface for ctypes; each entry returns its CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "row_loops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rowloops;

__global__ void empty() {}

__global__ void syncs(int k) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < k; ++i) grid.sync();
}

template <typename T>
__global__ void k6_chain(const T* __restrict__ v, T lam, T* __restrict__ x, long long n,
                         int steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T vi = v[i];
  T xi = vi;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const T s = T(1) / (T(1) + t_exp(-xi));
    const T g = xi + lam * s - vi;
    const T gp = T(1) + lam * s * (T(1) - s);
    xi = xi - g / gp;
  }
  x[i] = xi;
}

// K8's g(x) = x + e^2x - s e^x - v, in its order
template <typename T> __device__ __forceinline__ T exp_g(T x, T s, T v, T& ex) {
  ex = t_exp(x);
  return x + ex * ex - s * ex - v;
}

template <typename T>
__global__ void epi_exp_chain(const T* __restrict__ v, const T* __restrict__ s,
                              T* __restrict__ x, long long n, int widen, int newton) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T vi = v[i], si = s[i];
  T ex;
  T lo = clamp_max(vi, T(0)) - T(1);
#pragma unroll 1
  for (int k = 0; k < widen; ++k) lo = exp_g(lo, si, vi, ex) > T(0) ? lo - T(2) * fabs(lo) - T(2) : lo;
  lo = tmax(lo, t_log(clamp_min(si, Lim<T>::tiny()) * T(0.5)));
  T xi = T(0.5) * (lo + vi);
#pragma unroll 1
  for (int k = 0; k < newton; ++k) {
    const T g = exp_g(xi, si, vi, ex);
    const T gp = T(1) + T(2) * ex * ex - si * ex;
    xi = tmin(tmax(xi - g / gp, lo), vi);
  }
  x[i] = t_exp(xi);
}

// Element i's steps where the warps' are given (widen, newton packed).
__device__ __forceinline__ void warp_counts(const int* warp_steps, long long i, int& widen,
                                            int& newton) {
  if (warp_steps == nullptr) return;
  const int packed = warp_steps[i >> 5];
  widen = packed & 0xffff;
  newton = packed >> 16;
}

template <typename T>
__global__ void kl_div_chain(const T* __restrict__ u, const T* __restrict__ v, T lam,
                             T* __restrict__ x, const int* __restrict__ warp_steps, long long n,
                             int widen, int newton) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  warp_counts(warp_steps, i, widen, newton);
  const T ui = u[i], vi = v[i];
  const T eps = T(sizeof(T) == 4 ? 1e-6 : 1e-13);
  const T lo = clamp_min((lam - vi) / lam + eps, eps);
  T hi = clamp_min(lo * T(2), T(1));
#pragma unroll 1
  for (int k = 0; k < widen; ++k) {
    const T g = lam * hi * hi + (vi - lam) * hi - ui + lam * t_log(hi);
    hi = g < T(0) ? T(2) * hi : hi;
  }
  T r = tmin(tmax(clamp_min((T(0.5) + lam - vi) / lam, eps), lo), hi);
#pragma unroll 1
  for (int k = 0; k < newton; ++k) {
    const T g = lam * r * r + (vi - lam) * r - ui + lam * t_log(r);
    const T gp = T(2) * lam * r + (vi - lam) + lam / r;
    r = tmin(tmax(r - g / gp, lo), hi);
  }
  const T y = lam * r + vi - lam;
  x[i] = y * r;
}

template <typename T>
__global__ void inv_pos_chain(const T* __restrict__ v, T lam, T* __restrict__ x,
                              const int* __restrict__ warp_steps, long long n, int widen,
                              int newton) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  warp_counts(warp_steps, i, widen, newton);
  const T vi = v[i];
  const T c = torch_cbrt(lam);
  T hi = clamp_min(vi, T(0)) + c + T(1);
#pragma unroll 1
  for (int k = 0; k < widen; ++k) hi = hi * hi * (hi - vi) - lam < T(0) ? T(2) * hi : hi;
  T xi = tmax(vi, c);
#pragma unroll 1
  for (int k = 0; k < newton; ++k) {
    const T g = xi * xi * (xi - vi) - lam;
    const T gp = T(3) * xi * xi - T(2) * vi * xi;
    xi = tmin(tmax(xi - g / gp, T(1e-12)), hi);
  }
  x[i] = xi;
}

// NEG_ENTR false: the SUM_EXP entry; true: the SUM_NEG_ENTR entry
template <typename T, bool NEG_ENTR>
__global__ void w_log_w_chain(const T* __restrict__ v, T lam, T* __restrict__ x,
                              const int* __restrict__ warp_steps, long long n, int steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (warp_steps != nullptr) steps = warp_steps[i >> 5];
  const T vi = v[i];
  const T c = NEG_ENTR ? (vi - lam) / lam - t_log(lam) : t_log(lam) + vi;
  const T tiny = Lim<T>::tiny();
  T w = clamp_min(c > T(1) ? c - t_log(clamp_min(c, T(1.1))) : t_exp(clamp_max(c, T(1))), tiny);
#pragma unroll 1
  for (int k = 0; k < steps; ++k) w = clamp_min(w - (w + t_log(w) - c) * w / (w + T(1)), tiny);
  x[i] = NEG_ENTR ? lam * w : vi - w;
}

template <typename T>
__global__ void cube_root(const T* __restrict__ a, T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = torch_cbrt(a[i]);
}

}  // namespace

extern "C" {

// One block of 128 threads, as a one-row launch of a per-row kernel.
int row_launch_floor(void* stream) {
  empty<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// One cooperative launch of `grid` blocks of `block` threads that waits at
// k grid syncs.
int grid_sync_floor(int grid, int block, int k, void* stream) {
  void* args[] = {&k};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)syncs, grid, block, args, 0,
                                                    static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

#define CHAIN_ENTRY(SUFFIX, T)                                                            \
  int k6_chain_##SUFFIX(const void* v, T lam, void* x, long long n, int steps,           \
                        void* stream) {                                                   \
    const int threads = element_threads(n);                                               \
    k6_chain<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,                    \
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(v), lam,     \
                                                       static_cast<T*>(x), n, steps);     \
    return (int)cudaGetLastError();                                                       \
  }                                                                                       \
  int epi_exp_chain_##SUFFIX(const void* v, const void* s, void* x, long long n, int widen,\
                             int newton, void* stream) {                                  \
    const int threads = element_threads(n);                                               \
    epi_exp_chain<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,               \
                       static_cast<cudaStream_t>(stream)>>>(                              \
        static_cast<const T*>(v), static_cast<const T*>(s), static_cast<T*>(x), n, widen, \
        newton);                                                                          \
    return (int)cudaGetLastError();                                                       \
  }

CHAIN_ENTRY(f32, float)
CHAIN_ENTRY(f64, double)

// K9-K11's chains (lam by value; `warp_steps` one int a warp, or null for
// the counts passed in every element), and the cube root alone.
#define CHAIN_ENTRY2(SUFFIX, T)                                                            \
  int kl_div_chain_##SUFFIX(const void* u, const void* v, T lam, void* x,                  \
                            const void* warp_steps, long long n, int widen, int newton,    \
                            void* stream) {                                                \
    const int threads = element_threads(n);                                                \
    kl_div_chain<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,                 \
                      static_cast<cudaStream_t>(stream)>>>(                                \
        static_cast<const T*>(u), static_cast<const T*>(v), lam, static_cast<T*>(x),       \
        static_cast<const int*>(warp_steps), n, widen, newton);                            \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  int inv_pos_chain_##SUFFIX(const void* v, T lam, void* x, const void* warp_steps,        \
                             long long n, int widen, int newton, void* stream) {           \
    const int threads = element_threads(n);                                                \
    inv_pos_chain<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,                \
                       static_cast<cudaStream_t>(stream)>>>(                               \
        static_cast<const T*>(v), lam, static_cast<T*>(x),                                 \
        static_cast<const int*>(warp_steps), n, widen, newton);                            \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  int w_log_w_chain_##SUFFIX(const void* v, T lam, void* x, const void* warp_steps,        \
                             long long n, int count, int neg_entr, void* stream) {         \
    const int threads = element_threads(n);                                                \
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);                       \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);                              \
    if (neg_entr)                                                                          \
      w_log_w_chain<T, true><<<blocks, threads, 0, s>>>(                                   \
          static_cast<const T*>(v), lam, static_cast<T*>(x),                               \
          static_cast<const int*>(warp_steps), n, count);                                  \
    else                                                                                   \
      w_log_w_chain<T, false><<<blocks, threads, 0, s>>>(                                  \
          static_cast<const T*>(v), lam, static_cast<T*>(x),                               \
          static_cast<const int*>(warp_steps), n, count);                                  \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  int cube_root_##SUFFIX(const void* a, void* out, long long n, void* stream) {            \
    if (n > 0) {                                                                           \
      const int threads = element_threads(n);                                              \
      cube_root<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,                  \
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(a),        \
                                                          static_cast<T*>(out), n);        \
    }                                                                                      \
    return (int)cudaGetLastError();                                                        \
  }

CHAIN_ENTRY2(f32, float)
CHAIN_ENTRY2(f64, double)

}  // extern "C"
