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
// clamp) and t = exp(x).  Each feeds its x back, so nothing is hoisted,
// and writes it out.  The source is built with the loop kernels' flags
// (--fmad=false).
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

}  // extern "C"
