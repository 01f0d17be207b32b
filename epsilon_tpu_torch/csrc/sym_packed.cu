// y = M X for a symmetric M held as packed lower-triangle T x T tiles.
//
// Replaces the Pallas TPU kernel `sym_packed_matmul` / `_sym_kernel` of
// epsilon_tpu/ops/pallas_kernels.py.  What it computes is the same: tile k
// sits at block coordinates (ii[k], jj[k]) with ii >= jj; it contributes
// M_ij x_j to row block i and, when i != j, M_ij^T x_i to row block j.
//
// Bound: device memory.  At n = 8192 in f32 the packed triangle is
// n^2/2 * 4 B = 134 MB per apply, about 40 us at the H100's 3.35 TB/s, against
// 2 n^2 R operations (0.13 GFLOP a column of x).  The design keeps the
// kernel's point: each tile is read from device memory once, for any R.
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
// One column (R = 1, the solver's matvec: tile_products<T, 1>).  One block
// per tile holds the tile in registers, 4 consecutive columns per lane and
// rows w, w + 8, ... per warp w, loaded with 16-byte coalesced loads; row
// products t x_j are summed across the lanes by warp shuffles, column
// products t^T x_i down each thread's rows and then across the warps
// through shared memory.
//
// Several columns (R >= 2: tile_products_wide).  Per column of x the R = 1
// layout pays a 5-level shuffle butterfly and a one-lane store for every
// row product, which made it slower than the dense matmul of the whole
// square at R = 8.  Here a block copies its tile (f32: the whole tile; f64:
// half of it, rows 64 s .. 64 s + 63, so that both types stage 64 KB and
// three blocks fit an SM) into shared memory with cp.async, rows padded by
// 16 bytes so that neighbouring rows start in different banks, and keeps it
// there while it loops over x's columns in chunks: of RC_MAX (f32 8, f64
// 4: the shared memory of three blocks an SM; 2 or 4 for a narrower R),
// then one of the rest, R rounded up to even (so R = 10 in f32 runs 8 + 2
// and no chunk but an odd R's last computes a column of zeros), the next
// chunk's x loaded into registers while the block computes: every tile
// byte leaves device memory once, whatever R.  Half the warps compute the row products
// t x_j, the other half the column products t^T x_i, each a
// register-blocked product from shared memory: a lane owns two rows (or
// pairs of adjacent columns) by the chunk's RC columns of x, and half of
// each product's warps sum the first half of the inner dimension, the
// other half the second, so that all lanes of a warp read the same x
// values (a broadcast) and neighbouring tile rows or columns.  The second
// half leaves its sums in the x area, the first adds them to its own in
// that order and stores; every lane stores.  In f64 the two halves of a
// tile write their column products to two slots (2k + 1 and 2K + k), which
// pass 2 (reduce_rows_halves) adds in that order.  The partials are
// 2K T R values (f64: 3K T R) written and read once: at R = 8 in f32 17 MB
// each way, about 12 % of the tiles' bytes.  f32 products stay on FFMA (no
// TF32: the port's numerics rule), f64 on DFMA.  On an H100 at n = 8192
// (chip_smoke.py phase 2) it runs at 0.47-0.74 of the bytes bound for R =
// 2..8 and beats dense @ X there, and at R = 10 in f32; wider, its products
// bound it (about 0.09 ms a chunk of 8 in f32, 0.07 a chunk of 4 in f64)
// and it is slower than dense @ X: f32 from R = 16, f64 from R = 10.
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

// -- several columns of x (R >= 2) -------------------------------------------

constexpr int PAD_BYTES = 16;       // added to each tile row in shared memory
constexpr int MAX_DEVICES = 64;

// Per element type: the tile rows a block holds (S: the whole tile in f32,
// half of it in f64, 64 KB either way), its threads (half of them for each
// product) and the widest chunk of x's columns that keeps three blocks an SM.
template <typename scalar_t> struct Wide;
template <> struct Wide<float> {
  static constexpr int S = T, THREADS = 256, RC_MAX = 8;
};
template <> struct Wide<double> {
  static constexpr int S = T / 2, THREADS = 128, RC_MAX = 4;
};

// Dynamic shared memory: the S tile rows (padded), then the chunk's x_i
// rows (S x RC) and x_j rows (T x RC).
template <typename scalar_t, int RC>
constexpr int wide_smem() {
  return (int)sizeof(scalar_t) *
         (Wide<scalar_t>::S * (T + PAD_BYTES / (int)sizeof(scalar_t)) +
          (Wide<scalar_t>::S + T) * RC);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// N consecutive values from shared memory, in 16-byte loads (float4,
// double2) where N values fill them, else in 8-byte ones (float2); p is
// aligned to the load's size.
template <int N, typename scalar_t>
__device__ __forceinline__ void lds(const scalar_t* p, scalar_t (&v)[N]) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int VN = (int)(sizeof(vec_t) / sizeof(scalar_t));
  if constexpr (N % VN == 0) {
#pragma unroll
    for (int e = 0; e < N / VN; ++e) {
      const vec_t w = reinterpret_cast<const vec_t*>(p)[e];
      const scalar_t* pw = reinterpret_cast<const scalar_t*>(&w);
#pragma unroll
      for (int j = 0; j < VN; ++j) v[e * VN + j] = pw[j];
    }
  } else {
    static_assert(sizeof(scalar_t) == 4 && N % 2 == 0, "8-byte loads: pairs of floats");
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const float2 w = reinterpret_cast<const float2*>(p)[e];
      v[2 * e] = w.x;
      v[2 * e + 1] = w.y;
    }
  }
}

// N values to shared memory, in stores as lds() loads.
template <int N, typename scalar_t>
__device__ __forceinline__ void sts(scalar_t* p, const scalar_t (&v)[N]) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int VN = (int)(sizeof(vec_t) / sizeof(scalar_t));
  if constexpr (N % VN == 0) {
#pragma unroll
    for (int e = 0; e < N / VN; ++e) {
      vec_t w;
      scalar_t* pw = reinterpret_cast<scalar_t*>(&w);
#pragma unroll
      for (int j = 0; j < VN; ++j) pw[j] = v[e * VN + j];
      reinterpret_cast<vec_t*>(p)[e] = w;
    }
  } else {
    static_assert(sizeof(scalar_t) == 4 && N % 2 == 0, "8-byte stores: pairs of floats");
#pragma unroll
    for (int e = 0; e < N / 2; ++e)
      reinterpret_cast<float2*>(p)[e] = make_float2(v[2 * e], v[2 * e + 1]);
  }
}

// A width of x's columns as a type, for the generic lambdas that take a
// chunk of x.
template <int N> struct Cols { static constexpr int value = N; };

// Block b takes rows S (b % H) .. S (b % H) + S - 1 of tile b / H (H = T /
// S).  The first half of the warps compute t x_j, the second t^T x_i (none
// on a diagonal tile); in each, the first half of its warps (h = 0) sums
// the first half of the inner dimension and the second (h = 1) the rest, so
// that every lane of a warp reads the same x values (one broadcast) and the
// same tile column or row as its neighbours (no bank conflict).  A lane
// owns MR rows of t x_j or PAIRS pairs of adjacent columns of t^T x_i,
// by the chunk's C columns of x.  Then h = 1 leaves its sums in the x
// area, and h = 0 adds them to its own, in that order, and stores.  The
// chunks are (R + 1) / RC of RC columns, then one of TAIL (0: none); a
// launch compiles only those two widths, which keeps the chunk of 8 in
// f32 within its registers.
template <typename scalar_t, int RC, int TAIL>
__global__ void __launch_bounds__(Wide<scalar_t>::THREADS, 3)
tile_products_wide(const scalar_t* __restrict__ tiles, const int* __restrict__ ii,
                   const int* __restrict__ jj, const scalar_t* __restrict__ x,
                   scalar_t* __restrict__ partial, int K, int R) {
  constexpr int S = Wide<scalar_t>::S;
  constexpr int NT = Wide<scalar_t>::THREADS;
  constexpr int HW = NT / 128;                        // warps a half of a product
  constexpr int H = T / S;                            // blocks a tile
  constexpr int TS = T + PAD_BYTES / (int)sizeof(scalar_t);  // padded row
  constexpr int V = 16 / (int)sizeof(scalar_t);       // values a 16-byte load
  constexpr int MR = S / (32 * HW);                   // rows a lane owns (t x_j)
  constexpr int PAIRS = T / (64 * HW);                // column pairs a lane owns (t^T x_i)
  constexpr int NACC = 2 * PAIRS > MR ? 2 * PAIRS : MR;
  static_assert(MR >= 1 && PAIRS >= 1 && HW >= 1 && MR * 32 * HW == S, "layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* ts = reinterpret_cast<scalar_t*>(smem_raw);     // S x TS
  scalar_t* xs_i = ts + S * TS;                              // S x C
  scalar_t* xs_j = xs_i + S * RC;                            // T x C
  // after the products, h = 1's sums: t x_j in xs_i's place (S x C),
  // t^T x_i in xs_j's (T x C)

  const int k = blockIdx.x / H;
  const int s = blockIdx.x % H;
  const int bi = ii[k];
  const int bj = jj[k];
  const bool offdiag = bi != bj;    // a diagonal tile is applied once
  const int tid = threadIdx.x;

  // the tile's rows S s .. S s + S - 1, 16 bytes a copy
  const scalar_t* src = tiles + (size_t)k * T * T + (size_t)s * S * T;
  for (int c = tid; c < S * T / V; c += NT) {
    const int r = c / (T / V);
    const int col = (c % (T / V)) * V;
    cp_async16(ts + r * TS + col, src + (size_t)r * T + col);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool row_role = warp < 2 * HW;
  const int h = (warp / HW) % 2;
  const int base = lane + 32 * (warp % HW);           // 0 .. 32 HW - 1
  scalar_t* out_row = partial + (size_t)(2 * k) * T * R + (size_t)s * S * R;
  scalar_t* out_col = partial + (size_t)(s == 0 ? 2 * k + 1 : 2 * K + k) * T * R;

  // f(Cols<c>{}) for a chunk width c of the launch: RC or TAIL
  auto by_width = [](int c, auto&& f) {
    if (c == RC) {
      f(Cols<RC>{});
    } else {
      if constexpr (TAIL > 0) f(Cols<TAIL>{});
    }
  };

  // x's chunk of C columns from column r0 for the block, thread tid's
  // share (elements tid + NT j of the C-wide xs_i, then of xs_j), loaded
  // into registers a chunk ahead
  scalar_t xi_next[S * RC / NT], xj_next[T * RC / NT];
  auto load_x = [&](auto cols, int r0) {
    constexpr int C = decltype(cols)::value;
    static_assert((S * C) % NT == 0 && (T * C) % NT == 0, "x chunk shares");
    const int rc = min(C, R - r0);
#pragma unroll
    for (int j = 0; j < S * C / NT; ++j) {
      const int e = tid + NT * j, q = e % C;
      xi_next[j] = q < rc ? x[(size_t)(bi * T + s * S + e / C) * R + r0 + q] : scalar_t(0);
    }
#pragma unroll
    for (int j = 0; j < T * C / NT; ++j) {
      const int e = tid + NT * j, q = e % C;
      xj_next[j] = q < rc ? x[(size_t)(bj * T + e / C) * R + r0 + q] : scalar_t(0);
    }
  };

  // both products of the tile with x's C columns from column r0; next is
  // the following chunk's width (0: none)
  auto chunk = [&](auto cols, int r0, int next) {
    constexpr int C = decltype(cols)::value;
    const int rc = min(C, R - r0);
    if (r0 > 0) __syncthreads();    // the previous chunk's sums are read
#pragma unroll
    for (int j = 0; j < S * C / NT; ++j) xs_i[tid + NT * j] = xi_next[j];
#pragma unroll
    for (int j = 0; j < T * C / NT; ++j) xs_j[tid + NT * j] = xj_next[j];
    if (r0 == 0) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // in flight while the block computes
    if (next > 0) by_width(next, [&](auto n) { load_x(n, r0 + C); });

    scalar_t acc[NACC][C];
#pragma unroll
    for (int m = 0; m < NACC; ++m)
#pragma unroll
      for (int q = 0; q < C; ++q) acc[m][q] = 0;
    if (row_role) {
      // rows base + S/MR m, inner columns T/2 h .. T/2 h + T/2 - 1
      const scalar_t* tp = ts + base * TS + (T / 2) * h;
      const scalar_t* xp = xs_j + (T / 2) * h * C;
#pragma unroll 2
      for (int c = 0; c < T / 2; c += V) {
        scalar_t tv[MR][V];
#pragma unroll
        for (int m = 0; m < MR; ++m) lds<V>(tp + m * (S / MR) * TS + c, tv[m]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          scalar_t xv[C];
          lds<C>(xp + (c + e) * C, xv);
#pragma unroll
          for (int m = 0; m < MR; ++m)
#pragma unroll
            for (int q = 0; q < C; ++q) acc[m][q] += tv[m][e] * xv[q];
        }
      }
    } else if (offdiag) {           // uniform across the block
      // columns 2 (base + 32 HW m) + {0, 1}, inner rows S/2 h .. S/2 h + S/2 - 1
      const scalar_t* tp = ts + (S / 2) * h * TS + 2 * base;
      const scalar_t* xp = xs_i + (S / 2) * h * C;
#pragma unroll 4
      for (int r = 0; r < S / 2; ++r) {
        scalar_t xv[C];
        lds<C>(xp + r * C, xv);
#pragma unroll
        for (int m = 0; m < PAIRS; ++m) {
          scalar_t tv[2];
          lds<2>(tp + r * TS + 64 * HW * m, tv);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int q = 0; q < C; ++q) acc[2 * m + e][q] += tv[e] * xv[q];
        }
      }
    }
    __syncthreads();                // the chunk's x is consumed
    if (h == 1) {
      if (row_role) {
#pragma unroll
        for (int m = 0; m < MR; ++m) sts<C>(xs_i + (base + (S / MR) * m) * C, acc[m]);
      } else if (offdiag) {
#pragma unroll
        for (int m = 0; m < PAIRS; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sts<C>(xs_j + (2 * (base + 32 * HW * m) + e) * C, acc[2 * m + e]);
      }
    }
    __syncthreads();
    if (h == 0) {
      if (row_role) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int row = base + (S / MR) * m;
          scalar_t other[C];
          lds<C>(xs_i + row * C, other);
          scalar_t* out = out_row + (size_t)row * R + r0;
#pragma unroll
          for (int q = 0; q < C; ++q)
            if (q < rc) out[q] = acc[m][q] + other[q];
        }
      } else if (offdiag) {
#pragma unroll
        for (int m = 0; m < PAIRS; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 2 * (base + 32 * HW * m) + e;
            scalar_t other[C];
            lds<C>(xs_j + col * C, other);
            scalar_t* out = out_col + (size_t)col * R + r0;
#pragma unroll
            for (int q = 0; q < C; ++q)
              if (q < rc) out[q] = acc[2 * m + e][q] + other[q];
          }
      }
    }
  };

  const int full = (R + (R & 1)) / RC * RC;           // columns in chunks of RC
  by_width(full > 0 ? RC : TAIL, [&](auto w) { load_x(w, 0); });
  for (int r0 = 0; r0 < full; r0 += RC)
    chunk(Cols<RC>{}, r0, r0 + RC < full ? RC : TAIL);
  if constexpr (TAIL > 0) chunk(Cols<TAIL>{}, full, 0);
}

// Pass 2 where a tile takes two blocks (f64): reduce_rows, with each
// t^T x_i contribution (odd slot 2k + 1) the sum of its two halves' slots
// 2k + 1 and 2K + k, in that order.
template <typename scalar_t>
__global__ void __launch_bounds__(RED_GROUPS * RED_ELEMS)
reduce_rows_halves(const scalar_t* __restrict__ partial, const int* __restrict__ row_ptr,
                   const int* __restrict__ entries, scalar_t* __restrict__ y, int R, int K) {
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
      for (int p = row_ptr[b] + g; p < end; p += RED_GROUPS) {
        const int slot = entries[p];
        scalar_t v = partial[(size_t)slot * TR + elem];
        if (slot & 1) v += partial[(size_t)(2 * K + slot / 2) * TR + elem];
        acc += v;
      }
    }
    red[g][e] = acc;
    __syncthreads();
    if (g == 0 && elem < TR) {
      scalar_t sum = red[0][e];
#pragma unroll
      for (int q = 1; q < RED_GROUPS; ++q) sum += red[q][e];
      y[(size_t)b * TR + elem] = sum;
    }
    __syncthreads();
  }
}

template <typename scalar_t, int RC, int TAIL>
cudaError_t launch_wide(const scalar_t* tiles, const int* ii, const int* jj, const scalar_t* x,
                        scalar_t* partial, int K, int R, cudaStream_t stream) {
  constexpr int smem = wide_smem<scalar_t, RC>();
  // the attributes once a device (each call costs tens of microseconds)
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(tile_products_wide<scalar_t, RC, TAIL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(tile_products_wide<scalar_t, RC, TAIL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  tile_products_wide<scalar_t, RC, TAIL>
      <<<K * (T / Wide<scalar_t>::S), Wide<scalar_t>::THREADS, smem, stream>>>(
          tiles, ii, jj, x, partial, K, R);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch_wide_any(const scalar_t* t, const int* i, const int* j, const scalar_t* xs,
                            scalar_t* p, int K, int R, cudaStream_t st) {
  // R rounded up to even, in chunks of RC (all of a narrow R: 2 or 4;
  // else RC_MAX) and a last one of the rest, TAIL = re % RC.  So R = 10 in
  // f32 runs a chunk of 8 and one of 2, and only an odd R's last chunk
  // computes a column of zeros.
  constexpr int MAX = Wide<scalar_t>::RC_MAX;
  const int re = R + (R & 1);
  if (re == 2) return launch_wide<scalar_t, 2, 0>(t, i, j, xs, p, K, R, st);
  if (re == 4 && MAX > 4) return launch_wide<scalar_t, 4, 0>(t, i, j, xs, p, K, R, st);
  switch (re % MAX) {
    case 2: return launch_wide<scalar_t, MAX, 2>(t, i, j, xs, p, K, R, st);
    case 4: return launch_wide<scalar_t, MAX, (MAX > 4 ? 4 : 0)>(t, i, j, xs, p, K, R, st);
    case 6: return launch_wide<scalar_t, MAX, (MAX > 6 ? 6 : 0)>(t, i, j, xs, p, K, R, st);
    default: return launch_wide<scalar_t, MAX, 0>(t, i, j, xs, p, K, R, st);
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
  const cudaError_t err = R == 1 ? launch_products<scalar_t, 1>(t, i, j, xs, p, K, R, st)
                                 : launch_wide_any<scalar_t>(t, i, j, xs, p, K, R, st);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (T * R + RED_ELEMS - 1) / RED_ELEMS;
  const dim3 grid(B, chunks < 65535 ? chunks : 65535);
  if (R > 1 && Wide<scalar_t>::S < T)
    reduce_rows_halves<scalar_t><<<grid, RED_GROUPS * RED_ELEMS, 0, st>>>(
        p, static_cast<const int*>(row_ptr), static_cast<const int*>(entries),
        static_cast<scalar_t*>(y), R, K);
  else
    reduce_rows<scalar_t><<<grid, RED_GROUPS * RED_ELEMS, 0, st>>>(
        p, static_cast<const int*>(row_ptr), static_cast<const int*>(entries),
        static_cast<scalar_t*>(y), R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sym_packed_tile() { return T; }

// The partial buffers of (T, R) a tile that a call of R columns in
// itemsize-byte elements writes: its t x_j and its t^T x_i, the latter in
// two halves where two blocks share a tile (f64, R >= 2); 0 for an
// argument out of range.
int sym_packed_partial_slots(int R, int itemsize) {
  if (R < 1 || (itemsize != 4 && itemsize != 8)) return 0;
  if (R == 1) return 2;
  return 1 + T / (itemsize == 4 ? Wide<float>::S : Wide<double>::S);
}

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
