// y = M X for a symmetric M held as packed lower-triangle T x T tiles.
//
// Replaces the Pallas TPU kernel `sym_packed_matmul` / `_sym_kernel` of
// epsilon_tpu/ops/pallas_kernels.py.  What it computes is the same: tile k
// sits at block coordinates (ii[k], jj[k]) with ii >= jj; it contributes
// M_ij x_j to row block i and, when i != j, M_ij^T x_i to row block j.
//
// Bound: device memory.  At n = 8192 in f32 the packed triangle is
// n^2/2 * 4 B = 134 MB per apply, about 40 us at the H100's 3.35 TB/s, against
// a few MFLOP of arithmetic.  The design keeps the kernel's point: each tile
// is read from device memory once.
//
// The TPU kernel keeps all of y resident in VMEM and relies on the in-order
// grid to accumulate into it.  GPU blocks run in no order, so instead:
//   pass 1 writes both products of every tile to a per-tile partial buffer
//     (2K, T, R), reading the tile from device memory once;
//   pass 2 (reduce_rows): each row block sums its contributions in the fixed
//     order of a CSR list built on the host when the tiles are packed.
// There are no float atomics and every sum has a fixed order, so the result
// is bitwise repeatable.  Accumulation is in the input type: f32 for f32,
// f64 for f64.
//
// Pass 1 (tile_products) runs one block per tile.  It holds the tile in
// registers, 4 consecutive columns per lane and rows w, w + 8, ... per warp
// w, loaded with 16-byte coalesced loads; row products t x_j are summed
// across the lanes by warp shuffles, column products t^T x_i down each
// thread's rows and then across the warps through shared memory.  R is
// taken in chunks of RC columns; a wider R re-reads the tile once per chunk.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;              // tile edge (matches SYM_TILE in sym_packed.py)
constexpr int WARPS = 8;            // pass 1: warp w holds rows w, w + 8, ...
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = T / WARPS;     // rows per warp
constexpr int CPT = T / 32;         // consecutive columns per lane
constexpr int RED_GROUPS = 8;       // pass 2: contribution lanes per element
constexpr int RED_ELEMS = 32;       // pass 2: elements per block

template <typename scalar_t> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename scalar_t>
__device__ __forceinline__ scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Dynamic shared memory: x_i chunk (T x RC), then the cross-warp column
// partials (WARPS x T x RC).
template <typename scalar_t, int RC>
constexpr int products_smem() { return (int)sizeof(scalar_t) * (1 + WARPS) * T * RC; }

template <typename scalar_t, int RC>
__global__ void __launch_bounds__(THREADS)
tile_products(const scalar_t* __restrict__ tiles, const int* __restrict__ ii,
              const int* __restrict__ jj, const scalar_t* __restrict__ x,
              scalar_t* __restrict__ partial, int R) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int V = sizeof(vec_t) / sizeof(scalar_t);
  constexpr int VPT = CPT / V;                         // vector loads per row
  // rows loaded ahead of use: all 16 in f32, 8 at a time in f64 (registers)
  constexpr int BATCH = sizeof(scalar_t) == 4 ? ROWS : ROWS / 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* xs_i = reinterpret_cast<scalar_t*>(smem_raw);  // T x RC
  scalar_t* red = xs_i + T * RC;                            // WARPS x T x RC

  const int k = blockIdx.x;
  const int bi = ii[k];
  const int bj = jj[k];
  const bool offdiag = bi != bj;    // a diagonal tile is applied once
  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int c0 = lane * CPT;        // this lane's first column
  const vec_t* tv = reinterpret_cast<const vec_t*>(tiles + (size_t)k * T * T);
  scalar_t* out_row = partial + (size_t)(2 * k) * T * R;      // t x_j  -> block bi
  scalar_t* out_col = partial + (size_t)(2 * k + 1) * T * R;  // t^T x_i -> block bj

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int rc = min(RC, R - r0);
    __syncthreads();  // the previous chunk's shared memory is consumed
    for (int e = tid; e < T * RC; e += THREADS) {
      const int q = e % RC;
      xs_i[e] = q < rc ? x[(size_t)(bi * T + e / RC) * R + r0 + q] : scalar_t(0);
    }
    scalar_t xj[CPT][RC];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int q = 0; q < RC; ++q)
        xj[c][q] = q < rc ? x[(size_t)(bj * T + c0 + c) * R + r0 + q] : scalar_t(0);
    scalar_t acc[CPT][RC];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[c][q] = 0;
    __syncthreads();  // xs_i staged

#pragma unroll
    for (int p0 = 0; p0 < ROWS; p0 += BATCH) {
      scalar_t t[BATCH][CPT];
#pragma unroll
      for (int p = 0; p < BATCH; ++p) {
        const vec_t* src = tv + (size_t)(w + WARPS * (p0 + p)) * (T / V) + lane * VPT;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const vec_t val = src[v];
          const scalar_t* pv = reinterpret_cast<const scalar_t*>(&val);
#pragma unroll
          for (int e = 0; e < V; ++e) t[p][v * V + e] = pv[e];
        }
      }
#pragma unroll
      for (int p = 0; p < BATCH; ++p) {
        const int r = w + WARPS * (p0 + p);
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          scalar_t s = 0;                       // (t x_j)[r], this lane's columns
#pragma unroll
          for (int c = 0; c < CPT; ++c) s += t[p][c] * xj[c][q];
          s = warp_sum(s);
          if (lane == 0 && q < rc) out_row[(size_t)r * R + r0 + q] = s;
          const scalar_t xr = xs_i[r * RC + q];  // (t^T x_i)[c] += t[r][c] x_i[r]
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[c][q] += t[p][c] * xr;
        }
      }
    }

    if (offdiag) {                  // uniform across the block
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int q = 0; q < RC; ++q) red[(w * T + c0 + c) * RC + q] = acc[c][q];
      __syncthreads();
      for (int e = tid; e < T * RC; e += THREADS) {
        const int q = e % RC;
        if (q >= rc) continue;
        scalar_t s = red[e];
#pragma unroll
        for (int ww = 1; ww < WARPS; ++ww) s += red[ww * T * RC + e];
        out_col[(size_t)(e / RC) * R + r0 + q] = s;
      }
    }
  }
}

// y[b] = sum of partial[entries[p]] for p in [row_ptr[b], row_ptr[b+1]).
// Lane g of each element takes p = row_ptr[b] + g, + 8, ...; the eight lane
// sums are then added in lane order.  Both orders are fixed.
template <typename scalar_t>
__global__ void __launch_bounds__(RED_GROUPS * RED_ELEMS)
reduce_rows(const scalar_t* __restrict__ partial, const int* __restrict__ row_ptr,
            const int* __restrict__ entries, scalar_t* __restrict__ y, int R) {
  __shared__ scalar_t red[RED_GROUPS][RED_ELEMS];
  const int b = blockIdx.x;
  const int e = threadIdx.x % RED_ELEMS;
  const int g = threadIdx.x / RED_ELEMS;
  const int TR = T * R;

  for (int base = blockIdx.y * RED_ELEMS; base < TR; base += gridDim.y * RED_ELEMS) {
    const int elem = base + e;
    scalar_t acc = 0;
    if (elem < TR) {
      const int end = row_ptr[b + 1];
      for (int p = row_ptr[b] + g; p < end; p += RED_GROUPS)
        acc += partial[(size_t)entries[p] * TR + elem];
    }
    red[g][e] = acc;
    __syncthreads();
    if (g == 0 && elem < TR) {
      scalar_t sum = red[0][e];
#pragma unroll
      for (int q = 1; q < RED_GROUPS; ++q) sum += red[q][e];
      y[(size_t)b * TR + elem] = sum;
    }
    __syncthreads();  // red is reused by the next element chunk
  }
}

template <typename scalar_t, int RC>
cudaError_t launch_products(const scalar_t* tiles, const int* ii, const int* jj,
                            const scalar_t* x, scalar_t* partial, int K, int R,
                            cudaStream_t stream) {
  const int smem = products_smem<scalar_t, RC>();
  cudaError_t err = cudaFuncSetAttribute(
      tile_products<scalar_t, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_products<scalar_t, RC><<<K, THREADS, smem, stream>>>(tiles, ii, jj, x, partial, R);
  return cudaGetLastError();
}

template <typename scalar_t>
int sym_packed_matmul(const void* tiles, const void* ii, const void* jj,
                      const void* row_ptr, const void* entries, const void* x,
                      void* partial, void* y, int K, int B, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scalar_t* t = static_cast<const scalar_t*>(tiles);
  const int* i = static_cast<const int*>(ii);
  const int* j = static_cast<const int*>(jj);
  const scalar_t* xs = static_cast<const scalar_t*>(x);
  scalar_t* p = static_cast<scalar_t*>(partial);
  // vectors in one chunk; otherwise chunks of 8 columns in f32 and 4 in f64
  // (register budget of the per-lane accumulators)
  constexpr int RC_WIDE = sizeof(scalar_t) == 4 ? 8 : 4;
  const cudaError_t err = R == 1 ? launch_products<scalar_t, 1>(t, i, j, xs, p, K, R, st)
                                 : launch_products<scalar_t, RC_WIDE>(t, i, j, xs, p, K, R, st);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (T * R + RED_ELEMS - 1) / RED_ELEMS;
  const dim3 grid(B, chunks < 65535 ? chunks : 65535);
  reduce_rows<scalar_t><<<grid, RED_GROUPS * RED_ELEMS, 0, st>>>(
      p, static_cast<const int*>(row_ptr), static_cast<const int*>(entries),
      static_cast<scalar_t*>(y), R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sym_packed_tile() { return T; }

int sym_packed_matmul_f32(const void* tiles, const void* ii, const void* jj,
                          const void* row_ptr, const void* entries, const void* x,
                          void* partial, void* y, int K, int B, int R, void* stream) {
  return sym_packed_matmul<float>(tiles, ii, jj, row_ptr, entries, x, partial, y,
                                  K, B, R, stream);
}

int sym_packed_matmul_f64(const void* tiles, const void* ii, const void* jj,
                          const void* row_ptr, const void* entries, const void* x,
                          void* partial, void* y, int K, int B, int R, void* stream) {
  return sym_packed_matmul<double>(tiles, ii, jj, row_ptr, entries, x, partial, y,
                                   K, B, R, stream);
}

}  // extern "C"
