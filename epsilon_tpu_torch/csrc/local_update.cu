// Consensus local update: for each scenario block s,
//   x_s    = Finv_s (Atb_s + rho (z - u_s))
//   xu_sum = sum over s of (x_s + u_s)
//
// Replaces the Pallas TPU kernel `fused_local_update` / `_make_kernel._kernel`
// of epsilon_tpu/ops/pallas_kernels.py.  It computes the same thing; it does
// not copy the TPU grid, whose in-order accumulation of xu across grid steps
// has no GPU counterpart.
//
// Bound: bytes.  Each call reads every block's n x n inverse once, S n^2
// elements, against 2 S n^2 flops.  At S = 40, n = 5000 in f32 that is 4 GB
// of device memory, about 1.2 ms at the H100's 3.35 TB/s; at S = 200, n = 200
// it is 32 MB in f32, which stays resident in the 50 MB L2 from one ADMM
// iteration to the next, and 64 MB in f64, which does not.  Every element of
// Finv is read exactly once; what the design works on is keeping those reads
// in flight without a gap.
//
// Pass 1 has two hand-written kernels; the caller's plan (local_update_plan in
// ops/kernels/local_update.py, by shape and alignment alone) says which runs.
//
// ring_x, the ring path: rows a multiple of 16 bytes and pointers 16-byte
//   aligned (so every item, the shorter last one of a block s included, is
//   one aligned copy), two slabs of the smallest item fit in shared memory,
//   and there are at least two items to a block.
//   * Persistent blocks.  The grid is SM count x resident blocks per SM.  A
//     work item is R consecutive rows of one Finv_s; block b walks the
//     contiguous run of items [b items / grid, (b + 1) items / grid), so the
//     assignment is static and mostly stays within one s.
//   * A ring of STAGES slabs in shared memory, filled by the copy engine.  An
//     item's rows are one contiguous run of R n elements: lane 0 of a
//     producer warp posts the byte count on the stage's "full" mbarrier
//     (mbarrier.expect_tx) and starts one 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx::bytes).  No tensor map is needed.  Loads in
//     flight cost no registers, and STAGES - 1 items are on their way while
//     one is consumed.
//   * The right-hand side under the copy.  After starting the copy the
//     producer warp computes rhs_s = Atb_s + rho (z - u_s) into one of
//     RHS_BUFS shared buffers (only when s changes; the first one is computed
//     by the whole block), then arrives on the "full" barrier, whose phase
//     completes when both the bytes and that arrival are in.
//   * Eight consumer warps wait on the stage's parity, read slab and rhs from
//     shared memory as 16-byte vectors, LANES lanes to a row on consecutive
//     addresses (8 lanes cover all 32 banks: no conflicts), reduce with the
//     warp shuffle, write x, and release the stage by arriving on its "empty"
//     barrier (one arrival per warp), which the producer waits on before it
//     overwrites the slab.  Parities flip once per walk round the ring.
//   * LANES: 8 lanes to a row where an item has 32 rows (at n = 200 in f32 a
//     row is 50 vectors: 7 trips of 8 lanes leave 6 of 56 slots empty, where
//     a whole warp to a row left 14 of 64), 32 where rows are long and few.
//   A wait that sees no progress for some seconds traps, so a wrong byte
//   count ends in a CUDA error and not in a hang.
//
// block_x, the streaming path: one block per (s, tile of 32 rows), rhs staged
//   CHUNK columns at a time in 16 KB of shared memory, so any n works; warp w
//   owns 4 rows and its lanes stride over the columns with 16-byte loads
//   where alignment allows and scalar loads otherwise.  It takes what the
//   ring cannot: rows or pointers off 16-byte alignment (n = 130 in f32, any
//   odd n) and rows too long for the ring; and what the ring is no faster
//   at: so few items that a persistent block would walk fewer than two.
//
// Pass 2 (block_sum): xu_sum[j] = sum_s x[s, j] + sum_s u[s, j].  A block owns
//   RED_COLS columns, RED_GROUPS lanes per column; lane g sums s = g,
//   g + RED_GROUPS, ... in order, u's share before it waits for pass 1 and
//   x's after, and the lane sums are added in a fixed tree and then in warp
//   order.  It is launched with programmatic dependent
//   launch: pass 1 signals griddepcontrol.launch_dependents as soon as each
//   block has started, so pass 2's launch and ramp overlap pass 1, and every
//   read of x comes after griddepcontrol.wait, which returns when pass 1 has
//   finished and its stores are visible.  No state is shared between calls.
//
// Results repeat bitwise: no float atomics; a row's dot product is summed in
// an order fixed by (n, type, path, LANES), LANES itself a function of (n,
// type); nothing depends on the grid, on which block ran an item or on when.
//
// rho is a runtime argument (the Pallas kernel bakes it into the trace, so
// every new rho compiles again).  Accumulation is in the input type: f32 for
// f32, f64 for f64.
//
// Plain C interface for ctypes.  The entry points take the plan as integers,
// check it (cudaErrorInvalidValue for a plan the kernels cannot run) and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int CHUNK_BYTES = 16384;  // rhs columns staged in shared memory at a time
constexpr int RED_GROUPS = 32;      // pass 2: lanes per column
constexpr int RED_COLS = 8;         // pass 2: columns per block
constexpr int CONSUMER_WARPS = 8;   // ring path; the producer is one more warp
constexpr int CONSUMER_THREADS = 32 * CONSUMER_WARPS;
constexpr int RING_THREADS = CONSUMER_THREADS + 32;
constexpr int MAX_STAGES = 8;
constexpr long long WATCHDOG_CYCLES = 8000000000LL;  // about 4 s

template <typename scalar_t> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename scalar_t>
__device__ __forceinline__ scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Programmatic dependent launch: let the next kernel of the stream be
// scheduled / wait until the previous one has finished and is visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long since = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (since == 0) since = clock64();
    else if (clock64() - since > WATCHDOG_CYCLES) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// rhs[0:n] = a + rho (z - us), 16-byte vectors, `count` threads of which this
// is number `rank`.
template <typename scalar_t>
__device__ __forceinline__ void fill_rhs(scalar_t* rhs, const scalar_t* a, const scalar_t* us,
                                         const scalar_t* z, scalar_t rho, int n, int rank,
                                         int count) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int V = sizeof(vec_t) / sizeof(scalar_t);
  const vec_t* av = reinterpret_cast<const vec_t*>(a);
  const vec_t* uv = reinterpret_cast<const vec_t*>(us);
  const vec_t* zv = reinterpret_cast<const vec_t*>(z);
  vec_t* out = reinterpret_cast<vec_t*>(rhs);
#pragma unroll 4
  for (int k = rank; k < n / V; k += count) {
    const vec_t fa = __ldg(av + k), fu = __ldg(uv + k), fz = __ldg(zv + k);
    vec_t h;
    const scalar_t* pa = reinterpret_cast<const scalar_t*>(&fa);
    const scalar_t* pu = reinterpret_cast<const scalar_t*>(&fu);
    const scalar_t* pz = reinterpret_cast<const scalar_t*>(&fz);
    scalar_t* ph = reinterpret_cast<scalar_t*>(&h);
#pragma unroll
    for (int e = 0; e < V; ++e) ph[e] = pa[e] + rho * (pz[e] - pu[e]);
    out[k] = h;
  }
}

// One consumer warp's share of an item: LANES lanes to a row.
template <typename scalar_t, int LANES>
__device__ __forceinline__ void consume(const scalar_t* slab, const scalar_t* rhs,
                                        scalar_t* __restrict__ xrows, int rows, int n,
                                        int warp, int lane) {
  using vec_t = typename Vec16<scalar_t>::type;
  constexpr int V = sizeof(vec_t) / sizeof(scalar_t);
  constexpr int GROUPS_PER_WARP = 32 / LANES;
  constexpr int GROUPS = CONSUMER_WARPS * GROUPS_PER_WARP;
  const int l = lane % LANES;
  const int nv = n / V;
  const vec_t* hv = reinterpret_cast<const vec_t*>(rhs);
  for (int first = warp * GROUPS_PER_WARP; first < rows; first += GROUPS) {
    const int r = first + lane / LANES;
    const bool active = r < rows;
    const vec_t* fv = reinterpret_cast<const vec_t*>(slab + (size_t)(active ? r : rows - 1) * n);
    scalar_t acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0;
#pragma unroll 4
    for (int k = l; k < nv; k += LANES) {
      const vec_t f = fv[k];
      const vec_t h = hv[k];
      const scalar_t* fp = reinterpret_cast<const scalar_t*>(&f);
      const scalar_t* hp = reinterpret_cast<const scalar_t*>(&h);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += fp[e] * hp[e];
    }
    scalar_t v = acc[0];
#pragma unroll
    for (int e = 1; e < V; ++e) v += acc[e];
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (l == 0 && active) xrows[r] = v;
  }
}

template <typename scalar_t, int LANES>
__global__ void __launch_bounds__(RING_THREADS)
ring_x(const scalar_t* __restrict__ Finv, const scalar_t* __restrict__ Atb,
       const scalar_t* __restrict__ u, const scalar_t* __restrict__ z, scalar_t rho,
       scalar_t* __restrict__ x, int n, int R, int stages, int rhs_bufs, int tiles, int items) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slab_bytes = R * n * (int)sizeof(scalar_t);
  const int rhs_stride = round16(n * (int)sizeof(scalar_t));
  unsigned char* rhs0 = smem + (size_t)stages * slab_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(rhs0 + (size_t)rhs_bufs * rhs_stride);
  const uint32_t slab_addr = shared_addr(smem);
  const uint32_t full = shared_addr(bars);
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int base = items / gridDim.x, extra = items % gridDim.x;
  const int begin = blockIdx.x * base + min((int)blockIdx.x, extra);
  const int count = base + ((int)blockIdx.x < extra ? 1 : 0);

  if (tid == 0) {
    for (int q = 0; q < stages; ++q) {
      mbar_init(full + 8 * q, 1);
      mbar_init(empty + 8 * q, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  launch_dependents();

  // item -> (s, first row, bytes)
  auto locate = [&](int item, int& s, int& row0, int& rows) {
    s = item / tiles;
    row0 = (item % tiles) * R;
    rows = min(R, n - row0);
  };
  auto start_copy = [&](int k) {  // one thread: post the bytes, start the copy
    int s, row0, rows;
    locate(begin + k, s, row0, rows);
    const int q = k % stages;
    const uint32_t bytes = (uint32_t)rows * n * sizeof(scalar_t);
    mbar_expect_tx(full + 8 * q, bytes);
    bulk_copy(slab_addr + q * slab_bytes, Finv + ((size_t)s * n + row0) * n, bytes,
              full + 8 * q);
  };

  // The first round of copies, and the first right-hand side under them.
  const int s_first = begin / tiles;
  if (tid == CONSUMER_THREADS)
    for (int k = 0; k < min(stages, count); ++k) start_copy(k);
  fill_rhs(reinterpret_cast<scalar_t*>(rhs0), Atb + (size_t)s_first * n, u + (size_t)s_first * n,
           z, rho, n, tid, RING_THREADS);
  __syncthreads();

  int s_prev = s_first, buf = 0;
  if (warp == CONSUMER_WARPS) {
    for (int k = 0; k < count; ++k) {
      const int q = k % stages;
      if (k >= stages) {
        mbar_wait(empty + 8 * q, ((k / stages) & 1) ^ 1);
        if (lane == 0) start_copy(k);
      }
      const int s = (begin + k) / tiles;
      if (s != s_prev) {
        s_prev = s;
        buf = (buf + 1) % rhs_bufs;
        fill_rhs(reinterpret_cast<scalar_t*>(rhs0 + (size_t)buf * rhs_stride),
                 Atb + (size_t)s * n, u + (size_t)s * n, z, rho, n, lane, 32);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full + 8 * q);
    }
  } else {
    for (int k = 0; k < count; ++k) {
      const int q = k % stages;
      int s, row0, rows;
      locate(begin + k, s, row0, rows);
      if (s != s_prev) {
        s_prev = s;
        buf = (buf + 1) % rhs_bufs;
      }
      mbar_wait(full + 8 * q, (k / stages) & 1);
      consume<scalar_t, LANES>(reinterpret_cast<const scalar_t*>(smem + (size_t)q * slab_bytes),
                               reinterpret_cast<const scalar_t*>(rhs0 + (size_t)buf * rhs_stride),
                               x + (size_t)s * n + row0, rows, n, warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * q);
    }
  }
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

  launch_dependents();
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
block_sum(const scalar_t* x, const scalar_t* __restrict__ u, scalar_t* __restrict__ xu,
          int S, int n) {
  constexpr int RED_WARPS = RED_GROUPS * RED_COLS / 32;
  __shared__ scalar_t red[RED_WARPS][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int g = threadIdx.x / RED_COLS;
  const int col = blockIdx.x * RED_COLS + c;
  // u is an input: its share is summed while pass 1 still runs
  scalar_t acc_u = 0;
  if (col < n) {
#pragma unroll 4
    for (int s = g; s < S; s += RED_GROUPS) acc_u += u[(size_t)s * n + col];
  }
  wait_for_primary();  // x is pass 1's output: no read of it before this
  scalar_t acc = 0;
  if (col < n) {
#pragma unroll 4
    for (int s = g; s < S; s += RED_GROUPS) acc += __ldcg(x + (size_t)s * n + col);
  }
  acc += acc_u;
  // the groups of one warp, then the warps in order
#pragma unroll
  for (int off = RED_COLS; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 < RED_COLS) red[threadIdx.x / 32][c] = acc;
  __syncthreads();
  if (threadIdx.x < RED_COLS && col < n) {
    scalar_t sum = red[0][c];
#pragma unroll
    for (int q = 1; q < RED_WARPS; ++q) sum += red[q][c];
    xu[col] = sum;
  }
}

// Bytes of dynamic shared memory of ring_x: slabs, right-hand sides, barriers.
int ring_smem_bytes(int n, int itemsize, int R, int stages, int rhs_bufs) {
  return stages * R * n * itemsize + rhs_bufs * round16(n * itemsize) + 16 * stages;
}

constexpr int MAX_DEVICES = 64;

// The most dynamic shared memory a block may ask for on the current device;
// asked of the runtime once per device.
int smem_limit(int dev) {
  static int limits[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (limits[dev] == 0 &&
      cudaDeviceGetAttribute(&limits[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    limits[dev] = 0;
  return limits[dev];
}

template <typename scalar_t, int LANES>
cudaError_t launch_ring(const scalar_t* F, const scalar_t* a, const scalar_t* us,
                        const scalar_t* zs, double rho, scalar_t* xs, int n, int R, int stages,
                        int rhs_bufs, int tiles, int items, int smem_bytes, int grid, int dev,
                        cudaStream_t st) {
  auto kernel = ring_x<scalar_t, LANES>;
  // above 48 KB a kernel must be allowed its dynamic shared memory: once per
  // device, up to the device's limit (the call costs tens of microseconds)
  static bool allowed[MAX_DEVICES];
  if (!allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_limit(dev));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  kernel<<<grid, RING_THREADS, smem_bytes, st>>>(F, a, us, zs, (scalar_t)rho, xs, n, R, stages,
                                                 rhs_bufs, tiles, items);
  return cudaGetLastError();
}

template <typename scalar_t>
int local_update(const void* Finv, const void* Atb, const void* u, const void* z,
                 double rho, void* x, void* xu, int S, int n, int ring, int R, int stages,
                 int rhs_bufs, int lanes, int smem_bytes, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scalar_t* F = static_cast<const scalar_t*>(Finv);
  const scalar_t* a = static_cast<const scalar_t*>(Atb);
  const scalar_t* us = static_cast<const scalar_t*>(u);
  const scalar_t* zs = static_cast<const scalar_t*>(z);
  scalar_t* xs = static_cast<scalar_t*>(x);
  if (S < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (ring) {
    const bool aligned = (n * sizeof(scalar_t)) % 16 == 0 &&
        (reinterpret_cast<size_t>(Finv) | reinterpret_cast<size_t>(Atb) |
         reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(z)) % 16 == 0;
    if (!aligned || R < 1 || stages < 2 || stages > MAX_STAGES || rhs_bufs < 1 ||
        rhs_bufs > stages || (long long)R * n * sizeof(scalar_t) >= (1 << 20))
      return (int)cudaErrorInvalidValue;
    const int tiles = (n + R - 1) / R;
    // a right-hand side may be overwritten only when its items are consumed
    if ((long long)(rhs_bufs - 1) * tiles < stages - 1) return (int)cudaErrorInvalidValue;
    if ((long long)S * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int items = S * tiles;
    if (grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
    // (a slab is under 1 MB, the most an mbarrier counts, so this cannot overflow)
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if (smem_bytes != ring_smem_bytes(n, sizeof(scalar_t), R, stages, rhs_bufs) ||
        smem_bytes > smem_limit(dev))
      return (int)cudaErrorInvalidValue;
    if (lanes == 8)
      err = launch_ring<scalar_t, 8>(F, a, us, zs, rho, xs, n, R, stages, rhs_bufs, tiles,
                                     items, smem_bytes, grid, dev, st);
    else if (lanes == 32)
      err = launch_ring<scalar_t, 32>(F, a, us, zs, rho, xs, n, R, stages, rhs_bufs, tiles,
                                      items, smem_bytes, grid, dev, st);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const int tiles = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if ((long long)S * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int blocks = S * tiles;
    if (grid != blocks) return (int)cudaErrorInvalidValue;
    const bool vec = (n * sizeof(scalar_t)) % 16 == 0 && reinterpret_cast<size_t>(Finv) % 16 == 0;
    if (vec)
      block_x<scalar_t, true><<<blocks, THREADS, 0, st>>>(F, a, us, zs, (scalar_t)rho, xs, n, tiles);
    else
      block_x<scalar_t, false><<<blocks, THREADS, 0, st>>>(F, a, us, zs, (scalar_t)rho, xs, n, tiles);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;

  // Pass 2 may be scheduled while pass 1 still runs (programmatic dependent
  // launch); it reads x only after griddepcontrol.wait.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + RED_COLS - 1) / RED_COLS);
  cfg.blockDim = dim3(RED_GROUPS * RED_COLS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, block_sum<scalar_t>, static_cast<const scalar_t*>(xs), us,
                           static_cast<scalar_t*>(xu), S, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int local_update_f32(const void* Finv, const void* Atb, const void* u, const void* z,
                     double rho, void* x, void* xu, int S, int n, int ring, int R, int stages,
                     int rhs_bufs, int lanes, int smem_bytes, int grid, void* stream) {
  return local_update<float>(Finv, Atb, u, z, rho, x, xu, S, n, ring, R, stages, rhs_bufs, lanes,
                             smem_bytes, grid, stream);
}

int local_update_f64(const void* Finv, const void* Atb, const void* u, const void* z,
                     double rho, void* x, void* xu, int S, int n, int ring, int R, int stages,
                     int rhs_bufs, int lanes, int smem_bytes, int grid, void* stream) {
  return local_update<double>(Finv, Atb, u, z, rho, x, xu, S, n, ring, R, stages, rhs_bufs, lanes,
                              smem_bytes, grid, stream);
}

}  // extern "C"
