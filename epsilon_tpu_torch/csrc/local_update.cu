// Consensus local update: for each scenario block s,
//   x_s    = Finv_s (Atb_s + rho (z - u_s))
//   xu_sum = sum over s of (x_s + u_s)
//
// Replaces the Pallas TPU kernel `fused_local_update` / `_make_kernel._kernel`
// of epsilon_tpu/ops/pallas_kernels.py.  It computes the same thing; it does
// not copy the TPU grid, whose in-order accumulation of xu across grid steps
// has no GPU counterpart.
//
// Bound: device memory.  Each iteration streams every block's n x n inverse
// once, S n^2 elements, against 2 S n^2 flops.  At S = 40, n = 5000 in f32
// that is 4 GB, about 1.2 ms at the H100's 3.35 TB/s; at S = 200, n = 200 it
// is 32 MB, which fits in the 50 MB L2.  The design reads each element of
// Finv exactly once, with coalesced 16-byte loads where alignment allows.
//
// Pass 1 (block_x): one block per (block s, tile of ROWS_PER_BLOCK rows).
//   The block stages rhs_s = Atb_s + rho (z - u_s) in shared memory, CHUNK
//   columns at a time, so any n works with a fixed 16 KB of shared memory.
//   Warp w owns rows w * ROWS_PER_WARP + r of the tile; its lanes stride over
//   the columns, every lane keeping ROWS_PER_WARP loads in flight, and a warp
//   shuffle reduces each row's dot product.  Rows past n are clamped to the
//   last row (read, never written), so the loop has no divergent branch.
//   Vector loads need the rows 16-byte aligned: n * sizeof(scalar_t) and
//   the pointer a multiple of 16 (n = 200 in f32 is, n = 130 is not);
//   otherwise the scalar loop runs.
// Pass 2 (block_sum): xu_sum[j], RED_GROUPS lanes per column, lane g summing
//   s = g, g + RED_GROUPS, ... in order, the lane sums then added in lane
//   order.  No float atomics and every sum has a fixed order, so results
//   repeat bitwise.  Its traffic is 2 S n elements.
//
// rho is a runtime argument (the Pallas kernel bakes it into the trace, so
// every new rho compiles again).  Accumulation is in the input type: f32 for
// f32, f64 for f64.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int CHUNK_BYTES = 16384;  // rhs columns staged in shared memory at a time
constexpr int RED_GROUPS = 8;       // pass 2: lanes per column
constexpr int RED_COLS = 32;        // pass 2: columns per block

template <typename scalar_t> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename scalar_t>
__device__ __forceinline__ scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename scalar_t, bool VEC>
__global__ void __launch_bounds__(THREADS)
block_x(const scalar_t* __restrict__ Finv, const scalar_t* __restrict__ Atb,
        const scalar_t* __restrict__ u, const scalar_t* __restrict__ z,
        scalar_t rho, scalar_t* __restrict__ x, int n, int tiles) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int V = sizeof(vec_t) / sizeof(scalar_t);
  constexpr int CHUNK = CHUNK_BYTES / sizeof(scalar_t);
  __shared__ __align__(16) scalar_t rhs[CHUNK];

  const int s = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int first = tile * ROWS_PER_BLOCK + (tid / 32) * ROWS_PER_WARP;
  const scalar_t* a = Atb + (size_t)s * n;
  const scalar_t* us = u + (size_t)s * n;
  const scalar_t* rows[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
    rows[r] = Finv + ((size_t)s * n + min(first + r, n - 1)) * n;

  scalar_t acc[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = 0;

  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int cn = min(CHUNK, n - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int j = tid; j < cn; j += THREADS)
      rhs[j] = a[c0 + j] + rho * (z[c0 + j] - us[c0 + j]);
    __syncthreads();
    int done = 0;
    if constexpr (VEC) {
      const int nv = cn / V;
      const vec_t* hv = reinterpret_cast<const vec_t*>(rhs);
      for (int k = lane; k < nv; k += 32) {
        const vec_t h = hv[k];
        const scalar_t* hp = reinterpret_cast<const scalar_t*>(&h);
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const vec_t f = __ldg(reinterpret_cast<const vec_t*>(rows[r] + c0) + k);
          const scalar_t* fp = reinterpret_cast<const scalar_t*>(&f);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r] += fp[e] * hp[e];
        }
      }
      done = nv * V;
    }
    for (int j = done + lane; j < cn; j += 32) {
      const scalar_t h = rhs[j];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] += __ldg(rows[r] + c0 + j) * h;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const scalar_t v = warp_sum(acc[r]);
    if (lane == 0 && first + r < n) x[(size_t)s * n + first + r] = v;
  }
}

template <typename scalar_t>
__global__ void __launch_bounds__(RED_GROUPS * RED_COLS)
block_sum(const scalar_t* __restrict__ x, const scalar_t* __restrict__ u,
          scalar_t* __restrict__ xu, int S, int n) {
  __shared__ scalar_t red[RED_GROUPS][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int g = threadIdx.x / RED_COLS;
  const int col = blockIdx.x * RED_COLS + c;
  scalar_t acc = 0;
  if (col < n)
    for (int s = g; s < S; s += RED_GROUPS)
      acc += x[(size_t)s * n + col] + u[(size_t)s * n + col];
  red[g][c] = acc;
  __syncthreads();
  if (g == 0 && col < n) {
    scalar_t sum = red[0][c];
#pragma unroll
    for (int q = 1; q < RED_GROUPS; ++q) sum += red[q][c];
    xu[col] = sum;
  }
}

template <typename scalar_t>
int local_update(const void* Finv, const void* Atb, const void* u, const void* z,
                 double rho, void* x, void* xu, int S, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scalar_t* F = static_cast<const scalar_t*>(Finv);
  const scalar_t* a = static_cast<const scalar_t*>(Atb);
  const scalar_t* us = static_cast<const scalar_t*>(u);
  const scalar_t* zs = static_cast<const scalar_t*>(z);
  scalar_t* xs = static_cast<scalar_t*>(x);
  const int tiles = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if ((long long)S * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int blocks = S * tiles;
  const bool vec = (n * sizeof(scalar_t)) % 16 == 0 && reinterpret_cast<size_t>(Finv) % 16 == 0;
  if (vec)
    block_x<scalar_t, true><<<blocks, THREADS, 0, st>>>(F, a, us, zs, (scalar_t)rho, xs, n, tiles);
  else
    block_x<scalar_t, false><<<blocks, THREADS, 0, st>>>(F, a, us, zs, (scalar_t)rho, xs, n, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_sum<scalar_t><<<(n + RED_COLS - 1) / RED_COLS, RED_GROUPS * RED_COLS, 0, st>>>(
      xs, us, static_cast<scalar_t*>(xu), S, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int local_update_f32(const void* Finv, const void* Atb, const void* u, const void* z,
                     double rho, void* x, void* xu, int S, int n, void* stream) {
  return local_update<float>(Finv, Atb, u, z, rho, x, xu, S, n, stream);
}

int local_update_f64(const void* Finv, const void* Atb, const void* u, const void* z,
                     double rho, void* x, void* xu, int S, int n, void* stream) {
  return local_update<double>(Finv, Atb, u, z, rho, x, xu, S, n, stream);
}

}  // extern "C"
