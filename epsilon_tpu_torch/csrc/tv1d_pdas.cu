// TV-1D prox by PDAS, the whole loop in one cooperative launch:
//
//     argmin_x (1/2)||x - v||^2 + lam ||D x||_1
//
// by a primal-dual active-set method on the dual box QP
// min_z (1/2)||D^T z - v||^2, |z| <= lam, for one row of length n.  On the
// main path it is the TOTAL_VARIATION_1D prox of tv_1d and fused_lasso
// (cold, or warm from the previous ADMM iteration's dual), and of each row
// of a stacked TV-1D family.
//
// The JAX package has no Pallas kernel here: XLA compiles
// epsilon_tpu/ops/prox/tv1d.py prox_tv1d_pdas, one lax.while_loop with its
// stop test on the device, into one program.  The port's plain version
// (epsilon_tpu_torch/ops/prox/tv1d.py prox_tv1d_pdas_reference) issues each
// round as about 1,200 eager operations (the PCR solve's shifts are cats)
// and reads the stop test back to the host once a round.  This kernel runs
// every round, and the stop test, on the device.
//
// A round, as tv1d.py's: g = D D^T z - dv; the active set from the
// primal-dual indicator (the first round never settles: the JAX package's
// sentinel act0 = 127); the tridiagonal system with pinned rows; its PCR
// solve (steps = ceil(log2 m) levels, m = n - 1); six trial steps of the
// projected line search and their changes of J = ||D^T z - v||^2; the full
// step, the argmin, or the incumbent where every trial rises; `settled`
// (the active set repeats and the full step descends); the duality gap.
// The loop goes on while not settled, the gap is above gap_tol and fewer
// than max_iters rounds ran; every block reads that test itself.
//
// Two builds of the loop, each one cooperative launch:
//
// pdas_tiles (the dispatch's; tv1d_pdas_{f32,f64}).  A round is bound by
// its chain of grid syncs, each about 1.1-1.3 us on an H100, and by passes
// a few dependent L2 loads long (196 blocks of 512 threads at n = 100,000:
// not one element a thread), so that a PCR level in device memory costs
// about 2.5 us.  So a round syncs as rarely as it can:
//   - the tile stage runs PCR levels 0..K-1 in shared memory.  Block b
//     takes tiles of T rows (every gridDim.x-th) and loads the tile's
//     rows with a halo of H = 2^K - 1 on each side of the level-0 system
//     (a, b, d; c = a) into a window, rows outside the row as identity
//     rows (b = 1, a = c = d = 0), so that a level reads its neighbours
//     with no test of the row's ends and the same operands as level_at.
//     Plain coalesced loads fill the window (in turns they beat 1-D bulk
//     copies, cp.async.bulk on an mbarrier).  The levels run in place,
//     each over the rows still needed after it (the valid window shrinks
//     by 2^k on each side at level k): each thread computes its rows into
//     registers, a block barrier, then writes them (past HELD_PASSES
//     passes of THREADS rows it writes each pass LAG passes later, once no
//     pass still to come reads the values it replaces: a tile level reads
//     up to 2^k <= 2 THREADS rows back, so LAG = 2 and K <= 11).  Level K's
//     system for the tile goes to device memory: one grid sync replaces K.
//     When steps <= K, every block solves the whole row in shared memory;
//   - the residue stage, where the plan takes it: from level K on, level k
//     at row i reads rows i -+ 2^k only, of i's residue mod P = 2^K, so the
//     system is P independent interleaved ones, class r holding rows r, r +
//     P, r + 2P, ... (count_r of them).  Their levels K..steps-1 are PCR on
//     each class at stride 2^(k-K) in its index j = (i - r) / P, with the
//     same end tests (i >= 2^k iff j >= 2^(k-K); i + 2^k < m iff j +
//     2^(k-K) < count_r), so the same operands in the same order.  The
//     tile stage writes level K's system class by class through its
//     window (row i at (i mod P) m_r + i / P, m_r = ceil(m / P): a warp
//     stores runs of a class's rows); a block loads `group` classes into
//     its window at a time (groups every gridDim.x-th), runs levels
//     K..steps-2 in place with level_at's tests of the class's ends (LAG 2,
//     or 4 past a stride of 2 THREADS: a level short of the last has a
//     stride under m_r / 2, and m_r rows fit), and the last as the solve
//     d / b straight to zn in row order.  One grid sync and one pass
//     replace the steps - K - 1 levels in device memory;
//   - otherwise levels K..steps-2 run in device memory, a sync each, and
//     the last level merges with the trial pass: a thread computes the
//     solve at i - 1, i and i + 1 itself;
//   - the next round's start (g, the active set, the system, the "changed"
//     flag) merges with the step pass, which already holds the stepped z
//     at i - 1, i and i + 1; round 0's with the opening pass.  The active
//     set alternates between two arrays by round parity: a row stored
//     where the same pass loaded it stalls the pass (five-fold at n =
//     10^6, where the arrays outgrow L2).
// 4 syncs a round with the residue stage, steps - K + 2 without (2 when
// steps <= K), against the levels build's steps + 3, and 2 more a call.
// The tile stage is bound by its instruction rate (two IEEE divisions a
// row and level, the halo's rows again), so K is, without the residue
// stage, where a level in shared memory stops costing less than one in
// device memory: 8 in f32, 7 in f64; with it, the least K from 7 whose
// classes fit (tile_plan).  T, K and the groups come from the
// wrapper (ops/kernels/tv1d_pdas.py tile_plan, from m, the grid and the
// dtype).  The grid is the levels build's, which the tile build keeps
// resident (Resident: two blocks an SM in f32, at most 64 registers; one
// in f64, at most 128; SMEM_BUDGET a block).
//
// pdas_levels (tv1d_pdas_levels_{f32,f64}, uncounted): the build it
// replaced, a grid sync after every PCR level and every pass, kept as the
// yardstick that the tile build is held to bitwise.
//
// Both repeat the plain version's elementwise operations in its order
// (--fmad=false; one PCR level is level_at for every row in both builds,
// so one solve equals pcr_tridiag_solve's bitwise: tv1d_pcr_{f32,f64} runs
// the tile build's solve alone), and both sum in one fixed order: the
// grid's blocks of THREADS, resident or as the row needs, whichever is
// fewer; a block's elements in grid-stride order, a warp butterfly, the
// warps in order; then every block sums the blocks' partials the same way.
// So every block holds the same bits, two runs give the same result, and
// the two builds give the same x, z, gap and rounds.  Only the sums (E g,
// E Q E, the gap, dv.dv, ||v||^2) round in another order than torch's.
//
// Bound: a round reads and writes each of about 15 arrays of m a few times
// (L2-resident at n = 100,000: 6 MB in f32; not at 10^6, 60 MB), so it is
// bound by its chain of grid syncs and passes and, at 10^6, by its stages
// in shared memory (the tile and the residue stage hold over four fifths of
// a round there), not by bytes or operations; chip_smoke.py's phase 7a times
// an empty cooperative kernel with the same syncs at the same grid
// (launch_floor.cu).  Both builds count the grid syncs they run (in a
// register) and block 0 adds the count to a counter on the device
// (Pdas::syncs), so that a call's syncs are measured, not inferred from its
// rounds.  Built with -DK7_PHASE_MARKS, both read clock64() at the phase
// boundaries of a round (MARK; tools/k7_phases.py); the port's build has
// no marks.
//
// Scratch (12 arrays of mp = m, with the residue stage m rounded up to
// 2^K, rounded up to 32 elements, so that every array starts on 128 bytes
// and a warp's 32 rows take whole cache lines; the partials, act, the
// flags) is allocated by the wrapper.  Plain C interface for ctypes; each
// launch entry returns its CUDA error code.

#include <cooperative_groups.h>

#include <cstdint>

#include "row_loops.cuh"

namespace cg = cooperative_groups;

#ifdef K7_PHASE_MARKS
// tools/k7_phases.py: thread 0 of block 0 reads clock64() at the phase
// boundaries of the first MARK_ROUNDS rounds, MARKS a round, into
// phase_marks (set by tv1d_pdas_set_marks; none while it is null).
constexpr int MARK_ROUNDS = 64, MARKS = 11;
__device__ long long* phase_marks = nullptr;
#define MARK(q)                                                                             \
  do {                                                                                      \
    if (phase_marks != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && it < MARK_ROUNDS) \
      phase_marks[it * MARKS + (q)] = clock64();                                            \
  } while (0)
#else
#define MARK(q) \
  do {          \
  } while (0)
#endif

namespace {

using namespace rowloops;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TRIALS = 6;
// partial sums of the trial pass: E.g and E.QE for each trial
constexpr int PART = 2 * TRIALS;
// Dynamic shared memory a block of the tile build may take: two blocks of
// THREADS stay resident on an SM (228 KB), as in the levels build, so both
// run the same grid (tile_plan's SMEM_BUDGET).
constexpr int SMEM_BUDGET = 110592;

// Blocks of THREADS an SM keeps resident of the tile build: the levels
// build's, two in f32 and one in f64 (where the levels build holds 78
// registers), so that both run one grid and the f64 tile build may take
// up to 128 registers.
template <typename T> struct Resident { static constexpr int blocks = sizeof(T) == 4 ? 2 : 1; };

// Passes of THREADS rows a tile level holds in registers at once (more
// spill in the kernel's other passes): K = 8 at the main path's tiles.
constexpr int HELD_PASSES = 3;

template <typename T> struct Eps;
template <> struct Eps<float> {
  static __device__ __forceinline__ float v() { return FLT_EPSILON; }
};
template <> struct Eps<double> {
  static __device__ __forceinline__ double v() { return DBL_EPSILON; }
};

// A tridiagonal system a_i z_{i-1} + b_i z_i + c_i z_{i+1} = d_i.
template <typename T> struct Sys { T* a; T* b; T* c; T* d; };

template <typename T> struct Pdas {
  const T* v;
  const T* z0;      // the warm dual, or nullptr (cold: z = 0)
  const T* lam_p;   // lam on the device, or nullptr (lam_value)
  T lam_value, tol;
  int n, max_iters, steps;
  int levels, tile, whole, group;  // the tile build's plan (tile_plan)
  T* x;
  T* z_out;
  T* gap_out;
  int* it_out;
  T* z[2];          // the dual, ping-ponged by the step pass
  T* zn;            // the PCR solve
  T* g;             // D D^T z - dv
  Sys<T> sys[2];    // PCR's ping-pong; sys[0] holds a round's level-0 system
  signed char* act; // the active set (the tile build's: two arrays of m, by
                    // round parity)
  T* part;          // per-block partial sums
  int* flags;       // per-block "the active set changed", by round parity
  unsigned long long* syncs;  // the grid syncs run, added to by block 0
};

// A grid sync, counted in `count` (a register of every thread).
__device__ __forceinline__ void counted_sync(cg::grid_group& grid, int& count) {
  ++count;
  grid.sync();
}


// torch.clamp(x, -lam, lam): NaN stays NaN
template <typename T> __device__ __forceinline__ T box(T x, T lam) {
  return clamp_max(clamp_min(x, -lam), lam);
}

// Q sums over the block, in a fixed order; every thread gets the sums.
// sh holds WARPS * Q + Q values.
template <int Q, typename T> __device__ __forceinline__ void block_sum(T (&s)[Q], T* sh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < Q; ++q) s[q] = warp_sum(s[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) sh[warp * Q + q] = s[q];
  }
  __syncthreads();
  if (threadIdx.x < Q) {
    T t = sh[threadIdx.x];
    for (int w = 1; w < WARPS; ++w) t += sh[w * Q + threadIdx.x];
    sh[WARPS * Q + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) s[q] = sh[WARPS * Q + q];
  __syncthreads();
}

// The blocks' partials (part[j * Q + q] for block j) summed in a fixed
// order; every block gets the same bits.
template <int Q, typename T> __device__ __forceinline__ void grid_sum(const T* part, T (&s)[Q],
                                                                      T* sh) {
#pragma unroll
  for (int q = 0; q < Q; ++q) s[q] = T(0);
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
#pragma unroll
    for (int q = 0; q < Q; ++q) s[q] += part[(long long)j * Q + q];
  }
  block_sum<Q>(s, sh);
}

template <int Q, typename T> __device__ __forceinline__ void put_partial(T* part, const T (&s)[Q]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) part[(long long)blockIdx.x * Q + q] = s[q];
  }
}

// One PCR level at row i of m, stride s = 2^k, reading src at array index
// x (= i less the array's first row): pcr_tridiag_solve's operations in its
// order.  Out-of-range neighbours are identity rows (b = 1, a = c = d = 0).
// The last level's solve is d / b.
template <typename T>
__device__ __forceinline__ void level_at(const Sys<T>& src, int x, int i, int s, int m, T& a,
                                         T& b, T& c, T& d) {
  const bool l = i >= s, r = s < m - i;
  const T bm = l ? src.b[x - s] : T(1), bp = r ? src.b[x + s] : T(1);
  const T am = l ? src.a[x - s] : T(0), ap = r ? src.a[x + s] : T(0);
  const T cm = l ? src.c[x - s] : T(0), cp = r ? src.c[x + s] : T(0);
  const T dm = l ? src.d[x - s] : T(0), dp = r ? src.d[x + s] : T(0);
  const T bi = src.b[x], di = src.d[x];
  const T alpha = -src.a[x] / bm;
  const T gamma = -src.c[x] / bp;
  // every read comes before the first write (a, b, c, d may be device memory)
  const T nb = bi + alpha * cm + gamma * ap;
  const T nd = di + alpha * dm + gamma * dp;
  b = nb;
  d = nd;
  a = alpha * am;
  c = gamma * cp;
}

// level_at in a window whose rows outside the row are identity rows:
// the same operations on the same operands, with no test of the ends.
template <typename T>
__device__ __forceinline__ void level_in(const Sys<T>& src, int x, int s, T& a, T& b, T& c,
                                         T& d) {
  const T bm = src.b[x - s], bp = src.b[x + s];
  const T am = src.a[x - s], ap = src.a[x + s];
  const T cm = src.c[x - s], cp = src.c[x + s];
  const T dm = src.d[x - s], dp = src.d[x + s];
  const T bi = src.b[x], di = src.d[x];
  const T alpha = -src.a[x] / bm;
  const T gamma = -src.c[x] / bp;
  const T nb = bi + alpha * cm + gamma * ap;
  const T nd = di + alpha * dm + gamma * dp;
  b = nb;
  d = nd;
  a = alpha * am;
  c = gamma * cp;
}

template <typename T> __device__ __forceinline__ T solve_at(const Sys<T>& src, int x, int i,
                                                            int s, int m) {
  T a, b, c, d;
  level_at(src, x, i, s, m, a, b, c, d);
  return d / b;
}

// PCR levels [k0, k1) in device memory, over the row grid-strided, from
// `from` (which holds level k0) ping-ponging with `other`, a grid sync
// after each (counted in `syncs`); returns the buffer that holds level k1.
template <typename T>
__device__ __forceinline__ Sys<T> device_levels(Sys<T> from, Sys<T> other, int k0, int k1, int m,
                                                cg::grid_group& grid, int& syncs) {
  const int stride = gridDim.x * THREADS;
  for (int k = k0; k < k1; ++k) {
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < m; i += stride)
      level_at(from, i, i, 1 << k, m, other.a[i], other.b[i], other.c[i], other.d[i]);
    counted_sync(grid, syncs);
    const Sys<T> t = from;
    from = other;
    other = t;
  }
  return from;
}

// pcr_tridiag_solve: `steps` steps of parallel cyclic reduction from src0,
// ping-ponging through s1 and s0 (step k writes s1 for even k, s0 for odd
// k, and reads what step k - 1 wrote), the last step writing d / b to out.
// Out-of-range neighbours are identity rows (b = 1, a = c = d = 0).  Each
// element's operations are the plain version's, in its order.
template <typename T>
__device__ __forceinline__ void pcr(const Sys<T>& src0, const Sys<T>& s0, const Sys<T>& s1, T* out,
                                    int m, int steps, cg::grid_group& grid, int& syncs) {
  const int stride = gridDim.x * THREADS;
  for (int k = 0; k < steps; ++k) {
    const Sys<T> src = k == 0 ? src0 : (k & 1 ? s1 : s0);
    const Sys<T> dst = k & 1 ? s0 : s1;
    const int s = 1 << k;
    const bool last = k == steps - 1;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < m; i += stride) {
      const bool l = i >= s, r = s < m - i;
      const T bm = l ? src.b[i - s] : T(1), bp = r ? src.b[i + s] : T(1);
      const T am = l ? src.a[i - s] : T(0), ap = r ? src.a[i + s] : T(0);
      const T cm = l ? src.c[i - s] : T(0), cp = r ? src.c[i + s] : T(0);
      const T dm = l ? src.d[i - s] : T(0), dp = r ? src.d[i + s] : T(0);
      const T alpha = -src.a[i] / bm;
      const T gamma = -src.c[i] / bp;
      const T b = src.b[i] + alpha * cm + gamma * ap;
      const T d = src.d[i] + alpha * dm + gamma * dp;
      if (last) {
        out[i] = d / b;
      } else {
        dst.a[i] = alpha * am;
        dst.c[i] = gamma * cp;
        dst.b[i] = b;
        dst.d[i] = d;
      }
    }
    counted_sync(grid, syncs);
  }
}

// ---------------------------------------------------------------------------
// The tile stage (shared memory)

// Rows a class of the residue stage holds at most: ceil(m / 2^levels).
__host__ __device__ __forceinline__ int class_rows(int m, int levels) {
  return (m + (1 << levels) - 1) >> levels;
}

// The tile build's window in rows (tile_plan's window): the tile and its
// halos, or the residue stage's group of classes (group > 0) where that is
// more, or the whole row and 2^(steps-1) rows past each end.
__host__ __device__ __forceinline__ int window_slots(int m, int steps, int levels, int tile,
                                                     int whole, int group) {
  if (whole) return m + (1 << steps);
  const int tiles = tile + 2 * ((1 << levels) - 1);
  const int classes = group * class_rows(m, levels);
  return tiles > classes ? tiles : classes;
}

// The length of each scratch array of the tile build: m rows, or with the
// residue stage 2^levels classes of class_rows, rounded up to 32.
inline long long scratch_rows(int m, int levels, int group) {
  const long long rows = group > 0 ? (long long)class_rows(m, levels) << levels : m;
  return (rows + 31) / 32 * 32;
}

// A block's window of the system in shared memory: a, b, c, d of `slots`
// rows each, row `first` of the row in slot 0 (first may be negative).
// Rows outside [0, m) hold identity rows (b = 1, a = c = d = 0), which no
// level writes, so a level reads its neighbours with no test: the same
// operands as level_at's.
template <typename T> struct Window {
  Sys<T> w;
  int first;
};

// Rows [first, end) of the row into the window: rows [0, m) of src (level
// 0, c = a when c_is_a) by plain coalesced loads, identity rows outside.
// The caller has synchronized the block since the window's last use.
template <typename T>
__device__ void load_window(const Sys<T>& src, bool c_is_a, Window<T>& win, int first, int end,
                            int m) {
  win.first = first;
  const int lo = max(first, 0), count = min(end, m) - lo;
  const Sys<T> w{win.w.a + (lo - first), win.w.b + (lo - first), win.w.c + (lo - first),
                 win.w.d + (lo - first)};
  for (int x = threadIdx.x; x < count; x += THREADS) {
    w.a[x] = src.a[lo + x];
    w.b[x] = src.b[lo + x];
    if (!c_is_a) w.c[x] = src.c[lo + x];
    w.d[x] = src.d[lo + x];
  }
  // identity rows before the row's start and from its end
  const int before = lo - first, after = max(end - m, 0);
  for (int j = threadIdx.x; j < before + after; j += THREADS) {
    const int x = j < before ? j : m - first + (j - before);
    win.w.a[x] = T(0);
    win.w.b[x] = T(1);
    win.w.c[x] = T(0);
    win.w.d[x] = T(0);
  }
  __syncthreads();
}

// One level over rows [lo, hi) of a window, in place: a thread computes
// rows lo + tid + r THREADS of pass r into registers (row(i, a, b, c, d),
// false where i holds no row) and put(i, a, b, c, d) writes them.  Up to
// HELD_PASSES passes it holds them all, and writes them after a block
// barrier; beyond, it writes pass r at pass r + LAG, after a barrier, when
// no pass still to come reads the values they replace (a row reads at most
// LAG THREADS rows back).
template <int LAG, typename T, typename Row, typename Put>
__device__ __forceinline__ void in_place(int lo, int hi, Row row, Put put) {
  const int passes = (hi - lo + THREADS - 1) / THREADS;
  if (passes <= HELD_PASSES) {
    // every pass computed at once (independent, so their latencies
    // overlap), one barrier, every pass written
    T a[HELD_PASSES], b[HELD_PASSES], c[HELD_PASSES], d[HELD_PASSES];
    bool ok[HELD_PASSES];
#pragma unroll
    for (int r = 0; r < HELD_PASSES; ++r) {
      const int i = lo + r * THREADS + threadIdx.x;
      ok[r] = i < hi && row(i, a[r], b[r], c[r], d[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < HELD_PASSES; ++r)
      if (ok[r]) put(lo + r * THREADS + threadIdx.x, a[r], b[r], c[r], d[r]);
    __syncthreads();
    return;
  }
  // slot q holds the pass computed q + 1 passes back
  T a[LAG], b[LAG], c[LAG], d[LAG];
  bool ok[LAG];
#pragma unroll
  for (int q = 0; q < LAG; ++q) {
    a[q] = b[q] = c[q] = d[q] = T(0);
    ok[q] = false;
  }
  for (int r = 0; r < passes + LAG; ++r) {
    const int i = lo + r * THREADS + threadIdx.x;
    T a0 = T(0), b0 = T(0), c0 = T(0), d0 = T(0);
    const bool ok0 = r < passes && i < hi && row(i, a0, b0, c0, d0);
    __syncthreads();
    if (ok[LAG - 1]) put(i - LAG * THREADS, a[LAG - 1], b[LAG - 1], c[LAG - 1], d[LAG - 1]);
#pragma unroll
    for (int q = LAG - 1; q > 0; --q) {
      a[q] = a[q - 1]; b[q] = b[q - 1]; c[q] = c[q - 1]; d[q] = d[q - 1];
      ok[q] = ok[q - 1];
    }
    a[0] = a0; b[0] = b0; c[0] = c0; d[0] = d0;
    ok[0] = ok0;
  }
  __syncthreads();
}

// A level's row into slot x of a window, or its solve d / b into the
// window's a.
template <typename T>
__device__ __forceinline__ void put_row(const Sys<T>& w, bool solve, int x, T a, T b, T c, T d) {
  if (solve) {
    w.a[x] = d / b;
  } else {
    w.a[x] = a;
    w.b[x] = b;
    w.c[x] = c;
    w.d[x] = d;
  }
}

// Where a tile level's results go: back into the window, the solve d / b
// into the window's a, or the level's system into device memory.
enum Out { TO_WINDOW, SOLVE_TO_WINDOW, TO_DEVICE };

// Level k over rows [lo, hi) of the window, in place (in_place with LAG 2:
// a row reads 2^k <= 2 THREADS rows back), or TO_DEVICE: level k + 1's
// system to dst, row i at i.
template <Out OUT, typename T>
__device__ void tile_level(const Window<T>& win, bool c_is_a, int lo, int hi, int k,
                           const Sys<T>& dst) {
  const int s = 1 << k;
  const Sys<T> src{win.w.a, win.w.b, c_is_a ? win.w.a : win.w.c, win.w.d};
  if (OUT == TO_DEVICE) {
    for (int i = lo + threadIdx.x; i < hi; i += THREADS)
      level_in(src, i - win.first, s, dst.a[i], dst.b[i], dst.c[i], dst.d[i]);
    return;
  }
  in_place<2, T>(
      lo, hi,
      [&](int i, T& a, T& b, T& c, T& d) {
        level_in(src, i - win.first, s, a, b, c, d);
        return true;
      },
      [&](int i, T a, T b, T c, T d) {
        put_row(win.w, OUT == SOLVE_TO_WINDOW, i - win.first, a, b, c, d);
      });
}

// Level `levels`' rows [t0, t1) from the window to dst, class by class of
// the rows mod P = 2^levels: row i at (i mod P) m_r + i / P.  t = (c P + r)
// W + u copies row j0 + c W + u of class r, j0 its first in the tile, W = 8
// (or fewer where a class has fewer rows in the tile), so that a warp
// stores 32 / W runs of W rows and reads each run's rows, P slots apart,
// from one bank: W-way conflicts in place of 32 partial sectors a store.
template <typename T>
__device__ void classes_out(const Window<T>& win, const Sys<T>& dst, int t0, int t1, int levels,
                            int m_r) {
  const int P = 1 << levels;
  const int most = (t1 - t0 + P - 1) >> levels;  // rows of a class in the tile, at most
  const int lw = most >= 8 ? 3 : most >= 4 ? 2 : most >= 2 ? 1 : 0, W = 1 << lw;
  const int total = ((most + W - 1) >> lw) << (lw + levels);
  for (int t = threadIdx.x; t < total; t += THREADS) {
    const int u = t & (W - 1), r = (t >> lw) & (P - 1), c = t >> (lw + levels);
    const int j = ((t0 - r + P - 1) >> levels) + c * W + u;
    const int i = r + (j << levels);
    if (i < t1) {
      const int x = i - win.first;
      const long long y = (long long)r * m_r + j;
      dst.a[y] = win.w.a[x];
      dst.b[y] = win.w.b[x];
      dst.c[y] = win.w.c[x];
      dst.d[y] = win.w.d[x];
    }
  }
}

// PCR levels 0..levels-1 of src (level 0; c = a when c_is_a) in shared
// memory.  whole: every block solves the whole row (levels = steps; the
// window reaches 2^(steps-1) rows past each end), the solve left in the
// window's a.  Otherwise tiles of `tile` rows, this block's every
// gridDim.x-th, each with a halo of 2^levels - 1 rows; level `levels`'
// system is written to dst for the tile's rows, in row order or, for the
// residue stage (group > 0), class by class (classes_out).
template <typename T>
__device__ void tile_stage(const Sys<T>& src, bool c_is_a, const Sys<T>& dst, Window<T>& win,
                           int m, int levels, int tile, bool whole, int group) {
  if (whole) {
    const int reach = 1 << (levels - 1);
    load_window(src, c_is_a, win, -reach, m + reach, m);
    for (int k = 0; k < levels - 1; ++k)
      tile_level<TO_WINDOW>(win, c_is_a && k == 0, 0, m, k, dst);
    tile_level<SOLVE_TO_WINDOW>(win, c_is_a && levels == 1, 0, m, levels - 1, dst);
    return;
  }
  const int halo = (1 << levels) - 1;
  const int tiles = (m + tile - 1) / tile;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int t0 = t * tile, t1 = min(t0 + tile, m);
    __syncthreads();
    load_window(src, c_is_a, win, t0 - halo, t1 + halo, m);
    for (int k = 0; k < levels; ++k) {
      // rows still needed after level k: 2^(k+1) - 1 of the halo are spent
      const int keep = halo - ((2 << k) - 1);
      const int lo = max(t0 - keep, 0), hi = min(t1 + keep, m);
      if (k == levels - 1 && group == 0)
        tile_level<TO_DEVICE>(win, c_is_a && k == 0, lo, hi, k, dst);
      else
        tile_level<TO_WINDOW>(win, c_is_a && k == 0, lo, hi, k, dst);
    }
    if (group > 0) classes_out(win, dst, t0, t1, levels, class_rows(m, levels));
  }
}

// The residue stage: PCR levels `levels`..steps-1 of the system of m rows
// whose level `levels` src holds class by class (row i at (i mod P) m_r +
// i / P, P = 2^levels, m_r = class_rows), the solve d / b to out in row
// order.  A block takes groups of `group` classes, every gridDim.x-th, into
// its window: row j of class r0 + q at slot q m_r + j.  Every level tests
// the class's ends (level_at), so that it reads no other class's row and no
// slot past a short class's last.
template <typename T>
__device__ void residue_stage(const Sys<T>& src, T* out, const Window<T>& win, int m, int steps,
                              int levels, int group) {
  const int P = 1 << levels, m_r = class_rows(m, levels);
  // x / m_r as __umulhi(x, magic), magic = ceil(2^32 / m_r): exact while
  // x (magic m_r - 2^32) < 2^32, as x and m_r are under 2^14 (SMEM_BUDGET)
  const unsigned magic = 0xffffffffu / (unsigned)m_r + 1u;
  const int groups = (P + group - 1) / group;
  const Sys<T> w = win.w;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int r0 = g * group, hi = min(group, P - r0) * m_r;
    const long long at = (long long)r0 * m_r;
    // slot x: its class r0 + q, its row j there, and whether the class has
    // that row
    auto place = [&](int x, int& q, int& j) {
      q = (int)__umulhi((unsigned)x, magic);
      j = x - q * m_r;
      return j < ((m - 1 - (r0 + q)) >> levels) + 1;
    };
    __syncthreads();
    for (int x = threadIdx.x; x < hi; x += THREADS) {
      int q, j;
      if (place(x, q, j)) {
        const long long y = at + (long long)q * m_r + j;
        w.a[x] = src.a[y];
        w.b[x] = src.b[y];
        w.c[x] = src.c[y];
        w.d[x] = src.d[y];
      }
    }
    __syncthreads();
    for (int k = levels; k < steps - 1; ++k) {
      const int s = 1 << (k - levels);
      auto row = [&](int x, T& a, T& b, T& c, T& d) {
        int q, j;
        if (!place(x, q, j)) return false;
        level_at(w, x, j, s, ((m - 1 - (r0 + q)) >> levels) + 1, a, b, c, d);
        return true;
      };
      auto put = [&](int x, T a, T b, T c, T d) { put_row(w, false, x, a, b, c, d); };
      if (s <= 2 * THREADS)
        in_place<2, T>(0, hi, row, put);
      else
        in_place<4, T>(0, hi, row, put);
    }
    const int s_last = 1 << (steps - 1 - levels);
    for (int x = threadIdx.x; x < hi; x += THREADS) {
      int q, j;
      if (place(x, q, j))
        out[r0 + q + (long long)j * P] =
            solve_at(w, x, j, s_last, ((m - 1 - (r0 + q)) >> levels) + 1);
    }
  }
}

// The window's arrays in the dynamic shared memory, `slots` rows each.
template <typename T> __device__ Window<T> make_window(unsigned char* smem, int slots) {
  T* base = reinterpret_cast<T*>(smem);
  return Window<T>{{base, base + slots, base + 2 * slots, base + 3 * slots}, 0};
}

// ---------------------------------------------------------------------------
// The PDAS

// (D^T w)_k = -w_k + w_{k-1} (tv1d._diff_t: the cat of -w and a zero, plus
// the cat of a zero and w), for k in [0, m]; wl = w_{k-1}, wk = w_k.
template <typename T> __device__ __forceinline__ T dt(T wl, T wk, int k, int m) {
  return (k < m ? -wk : T(0)) + (k > 0 ? wl : T(0));
}

// Round r's start at row i from z at i - 1, i, i + 1: g, the active set
// (act + (r mod 2) m) and the level-0 system (c = a); returns whether the
// active set changed from round r - 1's (first: round 0, which never
// settles, reads no earlier set).
template <typename T>
__device__ __forceinline__ int round_start(const Pdas<T>& p, int i, int m, T lam, T zl, T zi,
                                           T zr, int r, bool first) {
  const T dv = p.v[i + 1] - p.v[i];
  const T gi = (dt(zi, zr, i + 1, m) - dt(zl, zi, i, m)) - dv;
  const bool hi = (-gi + (zi - lam)) > T(0);
  const bool lo = (-gi + (zi + lam)) < T(0);
  const signed char a = (signed char)((int)hi - (int)lo);
  signed char* act = p.act + (long long)(r & 1) * m;
  const int changed = first || a != act[(long long)(1 - 2 * (r & 1)) * m + i];
  act[i] = a;
  const bool inactive = a == 0;
  p.sys[0].b[i] = inactive ? T(2) : T(1);
  p.sys[0].a[i] = inactive ? T(-1) : T(0);
  p.sys[0].d[i] = inactive ? dv : (hi ? lam : -lam);
  p.g[i] = gi;
  return changed;
}

// The trial steps at row i from z and the solve zn at i - 1, i, i + 1:
// adds E_j.g and E_j.Q E_j (E_j = box(z + alpha_j (zn - z)) - z) to s.
template <typename T>
__device__ __forceinline__ void trials_at(T (&s)[PART], int i, int m, T lam, T gi, T zl, T zi,
                                          T zr, T nl, T ni, T nr) {
  T al = T(1);
#pragma unroll
  for (int j = 0; j < TRIALS; ++j) {
    const T el = box(zl + al * (nl - zl), lam) - zl;
    const T ei = box(zi + al * (ni - zi), lam) - zi;
    const T er = box(zr + al * (nr - zr), lam) - zr;
    const T qe = dt(ei, er, i + 1, m) - dt(el, ei, i, m);
    s[j] += ei * gi;
    s[TRIALS + j] += ei * qe;
    al = T(0.5) * al;
  }
}

// The trials' partial sums (summed over the grid) -> the step: alpha and
// whether even the best trial rises (the incumbent stays); full_ok.
template <typename T>
__device__ __forceinline__ void choose_step(const T (&s)[PART], T tol0, T& al, bool& worse,
                                            bool& full_ok) {
  T trials[TRIALS];
#pragma unroll
  for (int j = 0; j < TRIALS; ++j) trials[j] = T(2) * s[j] + s[TRIALS + j];
  full_ok = trials[0] <= tol0;
  // torch.argmin: the first least value, NaN counting as the least
  int best = 0;
#pragma unroll
  for (int j = 1; j < TRIALS; ++j) {
    const T tb = trials[best], tj = trials[j];
    if (tb == tb && (tj != tj || tj < tb)) best = j;
  }
  const int idx = full_ok ? 0 : best;
  al = T(1);
  for (int j = 0; j < idx; ++j) al = T(0.5) * al;
  const T t_idx = idx == 0 ? trials[0] : idx == 1 ? trials[1] : idx == 2 ? trials[2]
                : idx == 3 ? trials[3] : idx == 4 ? trials[4] : trials[5];
  worse = t_idx > tol0;
}

// The stop test after round it, in every block on the same partials.
template <typename T>
__device__ __forceinline__ bool go_on(const Pdas<T>& p, const T* part_g, int it, bool full_ok,
                                      T gap_tol, T* sh) {
  T gs[1];
  grid_sum<1>(part_g, gs, sh);
  int any = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS)
    any |= p.flags[(it & 1) * gridDim.x + j];
  any = __syncthreads_or(any);
  const bool settled = !any && full_ok;
  return !settled && gs[0] > gap_tol;
}

// x = v - D^T z and the gap of z = box(z), written by block 0 with the
// rounds and the syncs (the count, which the grid sync here ends).
template <typename T>
__device__ __forceinline__ void finish(const Pdas<T>& p, const T* z, T lam, T* part_f, int it,
                                       T* sh, cg::grid_group& grid, int& syncs) {
  const int n = p.n, m = n - 1;
  const int stride = gridDim.x * THREADS;
  T fs[1] = {T(0)};
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const T wi = i < m ? box(z[i], lam) : T(0);
    const T wl = i > 0 ? box(z[i - 1], lam) : T(0);
    const T xi = p.v[i] - dt(wl, wi, i, m);
    p.x[i] = xi;
    if (i < m) {
      const T wr = i + 1 < m ? box(z[i + 1], lam) : T(0);
      p.z_out[i] = wi;
      const T d = (p.v[i + 1] - dt(wi, wr, i + 1, m)) - xi;
      fs[0] += lam * fabs(d) - wi * d;
    }
  }
  block_sum<1>(fs, sh);
  put_partial<1>(part_f, fs);
  counted_sync(grid, syncs);
  if (blockIdx.x == 0) {
    grid_sum<1>(part_f, fs, sh);
    if (threadIdx.x == 0) {
      *p.gap_out = fs[0];
      *p.it_out = it;
      atomicAdd(p.syncs, (unsigned long long)syncs);
    }
  }
}

template <typename T> struct Partials {
  T* t;  // gridDim.x x PART, the trials
  T* g;  // gridDim.x, the gap
  T* s;  // gridDim.x x 2, the opening sums
  T* f;  // gridDim.x, the final gap
  __device__ explicit Partials(T* part)
      : t(part), g(part + gridDim.x * PART), s(g + gridDim.x), f(s + 2 * gridDim.x) {}
};

// The opening sums dv.dv and ||v||^2 -> the descent slack at the roundoff
// scale of the quadratic form, and the gap threshold 0.5 (tol max(1,
// ||v||))^2 (tv1d.tv_gap_tol).
template <typename T>
__device__ __forceinline__ void thresholds(const Pdas<T>& p, const T* part_s, T* sh, T& tol0,
                                           T& gap_tol) {
  T s2[2];
  grid_sum<2>(part_s, s2, sh);
  tol0 = T(64) * Eps<T>::v() * (T(1) + s2[0]);
  const T scaled = p.tol * clamp_min(t_sqrt(s2[1]), T(1));
  gap_tol = T(0.5) * (scaled * scaled);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Resident<T>::blocks) pdas_tiles(Pdas<T> p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[WARPS * PART + PART];
  const int n = p.n, m = n - 1;
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  const T* v = p.v;
  const T lam = p.lam_p == nullptr ? p.lam_value : *p.lam_p;
  const Partials<T> part(p.part);
  const bool whole = p.whole != 0;
  const bool residue = p.group > 0;
  Window<T> win =
      make_window<T>(smem, window_slots(m, p.steps, p.levels, p.tile, whole, p.group));
  int syncs = 0;

  // the opening: z, dv.dv, ||v||^2 and round 0's start
  {
    T s[2] = {T(0), T(0)};
    auto z0_at = [&](int k) { return p.z0 == nullptr ? T(0) : box(p.z0[k], lam); };
    for (int i = first; i < n; i += stride) {
      if (i < m) {
        const T zi = z0_at(i);
        p.z[0][i] = zi;
        const T dv = v[i + 1] - v[i];
        s[0] += dv * dv;
        round_start(p, i, m, lam, i > 0 ? z0_at(i - 1) : T(0), zi,
                    i + 1 < m ? z0_at(i + 1) : T(0), 0, true);
      }
      s[1] += v[i] * v[i];
    }
    block_sum<2>(s, sh);
    put_partial<2>(part.s, s);
    if (threadIdx.x == 0) p.flags[blockIdx.x] = 1;
  }
  counted_sync(grid, syncs);
  T tol0, gap_tol;
  thresholds(p, part.s, sh, tol0, gap_tol);

  int it = 0, cur = 0;
  while (true) {
    MARK(0);
    const T* z = p.z[cur];
    // the solve: levels 0..K-1 in shared memory, then K..steps-1 in the
    // residue stage (zn), or K..steps-2 in device memory and the last
    // merged with the trials (whole: all in shared memory)
    tile_stage(p.sys[0], true, p.sys[1], win, m, p.levels, p.tile, whole, p.group);
    MARK(1);
    if (!whole) counted_sync(grid, syncs);
    MARK(2);
    Sys<T> held = p.sys[1];
    if (residue)
      residue_stage(p.sys[1], p.zn, win, m, p.steps, p.levels, p.group);
    else if (!whole)
      held = device_levels(p.sys[1], p.sys[0], p.levels, p.steps - 1, m, grid, syncs);
    MARK(3);
    if (residue) counted_sync(grid, syncs);
    MARK(4);
    const int s_last = 1 << (p.steps - 1);
    auto zn_at = [&](int q) {
      return whole     ? win.w.a[q - win.first]
             : residue ? p.zn[q]
                       : solve_at(held, q, q, s_last, m);
    };

    // the trial steps, with the solve at i - 1, i, i + 1
    T s[PART];
#pragma unroll
    for (int q = 0; q < PART; ++q) s[q] = T(0);
    for (int i = first; i < m; i += stride) {
      const T ni = zn_at(i);
      if (!residue) p.zn[i] = ni;
      trials_at(s, i, m, lam, p.g[i], i > 0 ? z[i - 1] : T(0), z[i], i + 1 < m ? z[i + 1] : T(0),
                i > 0 ? zn_at(i - 1) : T(0), ni, i + 1 < m ? zn_at(i + 1) : T(0));
    }
    block_sum<PART>(s, sh);
    MARK(5);
    put_partial<PART>(part.t, s);
    counted_sync(grid, syncs);
    MARK(6);
    grid_sum<PART>(part.t, s, sh);
    T al;
    bool worse, full_ok;
    choose_step(s, tol0, al, worse, full_ok);
    MARK(7);

    // the step (the incumbent where even the best trial rises), the gap of
    // the new z (x_d = v - D^T z, d = D x_d, sum lam |d| - z d) and the
    // next round's start
    T* zo = p.z[1 - cur];
    T gs[1] = {T(0)};
    int changed = 0;
    for (int i = first; i < m; i += stride) {
      auto stepped = [&](int k) {
        const T zk = z[k];
        return worse ? zk : box(zk + al * (p.zn[k] - zk), lam);
      };
      const T wi = stepped(i);
      const T wl = i > 0 ? stepped(i - 1) : T(0);
      const T wr = i + 1 < m ? stepped(i + 1) : T(0);
      zo[i] = wi;
      const T d = (v[i + 1] - dt(wi, wr, i + 1, m)) - (v[i] - dt(wl, wi, i, m));
      gs[0] += lam * fabs(d) - wi * d;
      changed |= round_start(p, i, m, lam, wl, wi, wr, it + 1, false);
    }
    changed = __syncthreads_or(changed);
    if (threadIdx.x == 0) p.flags[((it + 1) & 1) * gridDim.x + blockIdx.x] = changed;
    block_sum<1>(gs, sh);
    MARK(8);
    put_partial<1>(part.g, gs);
    counted_sync(grid, syncs);
    MARK(9);

    const bool go = go_on(p, part.g, it, full_ok, gap_tol, sh);
    MARK(10);
    ++it;
    cur = 1 - cur;
    if (it >= p.max_iters || !go) break;
  }
  finish(p, p.z[cur], lam, part.f, it, sh, grid, syncs);
}

// The levels build, as it was before the tile build replaced it, with its
// syncs counted and the phase marks.
template <typename T>
__global__ void __launch_bounds__(THREADS) pdas_levels(Pdas<T> p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[WARPS * PART + PART];
  const int n = p.n, m = n - 1;
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  const T* v = p.v;
  const T lam = p.lam_p == nullptr ? p.lam_value : *p.lam_p;
  T* part_t = p.part;                        // gridDim.x x PART
  T* part_g = part_t + gridDim.x * PART;     // gridDim.x
  T* part_s = part_g + gridDim.x;            // gridDim.x x 2
  T* part_f = part_s + 2 * gridDim.x;        // gridDim.x
  int syncs = 0;

  // the start: z, dv.dv and ||v||^2
  {
    T s[2] = {T(0), T(0)};
    for (int i = first; i < n; i += stride) {
      if (i < m) {
        p.z[0][i] = p.z0 == nullptr ? T(0) : box(p.z0[i], lam);
        const T dv = v[i + 1] - v[i];
        s[0] += dv * dv;
      }
      s[1] += v[i] * v[i];
    }
    block_sum<2>(s, sh);
    put_partial<2>(part_s, s);
  }
  counted_sync(grid, syncs);
  T s2[2];
  grid_sum<2>(part_s, s2, sh);
  // descent slack at the roundoff scale of the quadratic form, and the gap
  // threshold 0.5 (tol max(1, ||v||))^2 (tv1d.tv_gap_tol)
  const T tol0 = T(64) * Eps<T>::v() * (T(1) + s2[0]);
  const T scaled = p.tol * clamp_min(t_sqrt(s2[1]), T(1));
  const T gap_tol = T(0.5) * (scaled * scaled);

  const Sys<T> src0{p.sys[0].a, p.sys[0].b, p.sys[0].a, p.sys[0].d};   // c = a
  int it = 0, cur = 0;
  while (true) {
    MARK(0);
    const T* z = p.z[cur];
    // g, the active set and the system
    int changed = it == 0;
    for (int i = first; i < m; i += stride) {
      const T zi = z[i];
      const T zl = i > 0 ? z[i - 1] : T(0);
      const T zr = i + 1 < m ? z[i + 1] : T(0);
      const T dv = v[i + 1] - v[i];
      const T gi = (dt(zi, zr, i + 1, m) - dt(zl, zi, i, m)) - dv;
      const bool hi = (-gi + (zi - lam)) > T(0);
      const bool lo = (-gi + (zi + lam)) < T(0);
      const signed char a = (signed char)((int)hi - (int)lo);
      changed |= a != p.act[i];
      p.act[i] = a;
      const bool inactive = a == 0;
      p.sys[0].b[i] = inactive ? T(2) : T(1);
      p.sys[0].a[i] = inactive ? T(-1) : T(0);
      p.sys[0].d[i] = inactive ? dv : (hi ? lam : -lam);
      p.g[i] = gi;
    }
    changed = __syncthreads_or(changed);
    MARK(1);
    if (threadIdx.x == 0) p.flags[(it & 1) * gridDim.x + blockIdx.x] = changed;
    counted_sync(grid, syncs);
    MARK(2);

    pcr(src0, p.sys[0], p.sys[1], p.zn, m, p.steps, grid, syncs);
    MARK(3);

    // the trial steps: E_j = box(z + alpha_j (z_new - z)) - z, and the
    // change of J, 2 E_j.g + E_j.Q E_j
    T s[PART];
#pragma unroll
    for (int q = 0; q < PART; ++q) s[q] = T(0);
    for (int i = first; i < m; i += stride) {
      const T zi = z[i], ni = p.zn[i], gi = p.g[i];
      const T zl = i > 0 ? z[i - 1] : T(0), nl = i > 0 ? p.zn[i - 1] : T(0);
      const T zr = i + 1 < m ? z[i + 1] : T(0), nr = i + 1 < m ? p.zn[i + 1] : T(0);
      T al = T(1);
#pragma unroll
      for (int j = 0; j < TRIALS; ++j) {
        const T el = box(zl + al * (nl - zl), lam) - zl;
        const T ei = box(zi + al * (ni - zi), lam) - zi;
        const T er = box(zr + al * (nr - zr), lam) - zr;
        const T qe = dt(ei, er, i + 1, m) - dt(el, ei, i, m);
        s[j] += ei * gi;
        s[TRIALS + j] += ei * qe;
        al = T(0.5) * al;
      }
    }
    block_sum<PART>(s, sh);
    MARK(4);
    put_partial<PART>(part_t, s);
    counted_sync(grid, syncs);
    MARK(5);
    grid_sum<PART>(part_t, s, sh);
    T trials[TRIALS];
#pragma unroll
    for (int j = 0; j < TRIALS; ++j) trials[j] = T(2) * s[j] + s[TRIALS + j];
    const bool full_ok = trials[0] <= tol0;
    // torch.argmin: the first least value, NaN counting as the least
    int best = 0;
#pragma unroll
    for (int j = 1; j < TRIALS; ++j) {
      const T tb = trials[best], tj = trials[j];
      if (tb == tb && (tj != tj || tj < tb)) best = j;
    }
    const int idx = full_ok ? 0 : best;
    T al = T(1);
    for (int j = 0; j < idx; ++j) al = T(0.5) * al;
    const T t_idx = idx == 0 ? trials[0] : idx == 1 ? trials[1] : idx == 2 ? trials[2]
                  : idx == 3 ? trials[3] : idx == 4 ? trials[4] : trials[5];
    const bool worse = t_idx > tol0;
    MARK(6);

    // the step (the incumbent where even the best trial rises), and the gap
    // of the new z: x_d = v - D^T z, d = D x_d, sum lam |d| - z d
    T* zo = p.z[1 - cur];
    T gs[1] = {T(0)};
    for (int i = first; i < m; i += stride) {
      auto stepped = [&](int k) {
        const T zk = z[k];
        return worse ? zk : box(zk + al * (p.zn[k] - zk), lam);
      };
      const T wi = stepped(i);
      const T wl = i > 0 ? stepped(i - 1) : T(0);
      const T wr = i + 1 < m ? stepped(i + 1) : T(0);
      zo[i] = wi;
      const T d = (v[i + 1] - dt(wi, wr, i + 1, m)) - (v[i] - dt(wl, wi, i, m));
      gs[0] += lam * fabs(d) - wi * d;
    }
    block_sum<1>(gs, sh);
    MARK(7);
    put_partial<1>(part_g, gs);
    counted_sync(grid, syncs);
    MARK(8);

    // the stop test, in every block on the same partials
    grid_sum<1>(part_g, gs, sh);
    int any = 0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS)
      any |= p.flags[(it & 1) * gridDim.x + j];
    any = __syncthreads_or(any);
    const bool settled = !any && full_ok;
    MARK(9);
    ++it;
    cur = 1 - cur;
    const bool go = !settled && gs[0] > gap_tol;
    if (it >= p.max_iters || !go) break;
  }

  finish(p, p.z[cur], lam, part_f, it, sh, grid, syncs);
}

// The tile build's solve alone: src (c separate), level K's system in s1,
// then the residue stage to out, or levels K..steps-2 in device memory and
// the last to out.
template <typename T>
__global__ void __launch_bounds__(THREADS, Resident<T>::blocks)
    pcr_tiles(Sys<T> src, Sys<T> s0, Sys<T> s1, T* out, int m, int steps, int levels, int tile,
              int whole, int group) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  int syncs = 0;   // counted, not reported
  Window<T> win = make_window<T>(smem, window_slots(m, steps, levels, tile, whole, group));
  tile_stage(src, false, s1, win, m, levels, tile, whole != 0, group);
  const int stride = gridDim.x * THREADS;
  if (whole) {
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < m; i += stride)
      out[i] = win.w.a[i - win.first];
    return;
  }
  grid.sync();
  if (group > 0) {
    residue_stage(s1, out, win, m, steps, levels, group);
    return;
  }
  const Sys<T> held = device_levels(s1, s0, levels, steps - 1, m, grid, syncs);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < m; i += stride)
    out[i] = solve_at(held, i, i, 1 << (steps - 1), m);
}

// ---------------------------------------------------------------------------
// Host side

// Blocks of THREADS resident on the current device for `kernel` with
// `smem` bytes of dynamic shared memory, cached; allows the kernel that
// much first (once a device).  The carveout is left to the runtime: a launch
// that takes less shared memory keeps more L1, which the passes in device
// memory read through.
template <typename K> int resident(K kernel, int slot, int smem) {
  static int cache[8][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  int& c = cache[slot][dev];
  if (c == 0) {
    int per_sm = 0, sms = 0;
    if (smem > 0 &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess)
      return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    c = per_sm * sms;
  }
  return c;
}

// The grid for a row of `len` elements: the resident blocks or the row's,
// whichever is fewer (0 when the occupancy query fails).
template <typename K> int grid_for(K kernel, int slot, int smem, int len) {
  const int most = resident(kernel, slot, smem);
  const int need = (len + THREADS - 1) / THREADS;
  return most < need ? most : (need > 0 ? need : 1);
}

// The length of each scratch array of a system of m rows (padded in the
// wrapper).
inline long long padded(int m) { return (m + 31LL) / 32 * 32; }

template <typename T> int slot_of(int base) { return base + (sizeof(T) == 8 ? 1 : 0); }

// The tile build's grid for a row of n: the levels build's (two blocks an
// SM in f32, one in f64, or the row's), so that both sum in one order; 0
// when an occupancy query fails or the tile build cannot keep that grid
// resident.
template <typename T> int tiles_grid(int n) {
  const int g = grid_for(pdas_levels<T>, slot_of<T>(4), 0, n);
  return resident(pdas_tiles<T>, slot_of<T>(0), SMEM_BUDGET) < g ? 0 : g;
}

// The PCR entry's grid for m rows: the tile build's for a row of m + 1,
// so that it solves on the PDAS's tiles.
template <typename T> int pcr_grid(int m) {
  const int g = tiles_grid<T>(m + 1);
  return resident(pcr_tiles<T>, slot_of<T>(2), SMEM_BUDGET) < g ? 0 : g;
}

template <typename T>
int launch_pdas(bool tiles, const void* v, const void* z0, const void* lam_p, T lam_value, T tol,
                int n, int max_iters, int steps, int levels, int tile, int whole, int group,
                void* x, void* z_out, void* gap, void* it, void* syncs, void* scratch,
                void* act, void* flags, int grid, void* stream) {
  const long long mp = tiles ? scratch_rows(n - 1, levels, group) : padded(n - 1);
  T* s = static_cast<T*>(scratch);
  Pdas<T> p;
  p.v = static_cast<const T*>(v);
  p.z0 = static_cast<const T*>(z0);
  p.lam_p = static_cast<const T*>(lam_p);
  p.lam_value = lam_value;
  p.tol = tol;
  p.n = n;
  p.max_iters = max_iters;
  p.steps = steps;
  p.levels = levels;
  p.tile = tile;
  p.whole = whole;
  p.group = group;
  p.x = static_cast<T*>(x);
  p.z_out = static_cast<T*>(z_out);
  p.gap_out = static_cast<T*>(gap);
  p.it_out = static_cast<int*>(it);
  p.z[0] = s;
  p.z[1] = s + mp;
  p.zn = s + 2 * mp;
  p.g = s + 3 * mp;
  p.sys[0] = Sys<T>{s + 4 * mp, s + 5 * mp, s + 6 * mp, s + 7 * mp};
  p.sys[1] = Sys<T>{s + 8 * mp, s + 9 * mp, s + 10 * mp, s + 11 * mp};
  p.part = s + 12 * mp;
  p.act = static_cast<signed char*>(act);
  p.flags = static_cast<int*>(flags);
  p.syncs = static_cast<unsigned long long*>(syncs);
  void* args[] = {&p};
  cudaError_t e;
  if (tiles) {
    const int smem =
        4 * (int)sizeof(T) * window_slots(n - 1, steps, levels, tile, whole, group);
    if (smem > SMEM_BUDGET || resident(pdas_tiles<T>, slot_of<T>(0), SMEM_BUDGET) == 0)
      return (int)cudaErrorInvalidValue;
    e = cudaLaunchCooperativeKernel((const void*)pdas_tiles<T>, grid, THREADS, args, smem,
                                    static_cast<cudaStream_t>(stream));
  } else {
    e = cudaLaunchCooperativeKernel((const void*)pdas_levels<T>, grid, THREADS, args, 0,
                                    static_cast<cudaStream_t>(stream));
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_pcr(const void* src, void* out, int m, int steps, int levels, int tile, int whole,
               int group, void* scratch, int grid, void* stream) {
  const long long mp = padded(m), sp = scratch_rows(m, levels, group);
  T* a = const_cast<T*>(static_cast<const T*>(src));
  T* s = static_cast<T*>(scratch);
  Sys<T> in{a, a + mp, a + 2 * mp, a + 3 * mp};
  Sys<T> s0{s, s + sp, s + 2 * sp, s + 3 * sp};
  Sys<T> s1{s + 4 * sp, s + 5 * sp, s + 6 * sp, s + 7 * sp};
  T* o = static_cast<T*>(out);
  const int smem = 4 * (int)sizeof(T) * window_slots(m, steps, levels, tile, whole, group);
  if (smem > SMEM_BUDGET || resident(pcr_tiles<T>, slot_of<T>(2), SMEM_BUDGET) == 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&in, &s0, &s1, &o, &m, &steps, &levels, &tile, &whole, &group};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)pcr_tiles<T>, grid, THREADS,
                                                    args, smem, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch the PDAS entries take: 12 arrays of mp (scratch_rows for the
// tile build's plan, m = n - 1 rounded up to 32 for the levels build) and
// 16 partials a block of T; act, 2 m bytes (the tile build) or m (the
// levels build); 2 ints a block of flags; one unsigned 64-bit counter, to
// which the launch adds the grid syncs it ran.
// The PCR entry: its system as 4 arrays of m rounded up to 32 (a, b, c, d)
// and 8 arrays of scratch_rows of scratch.
int tv1d_pdas_threads() { return THREADS; }
int tv1d_pdas_smem_budget() { return SMEM_BUDGET; }
int tv1d_pdas_grid_f32(int n) { return tiles_grid<float>(n); }
int tv1d_pdas_grid_f64(int n) { return tiles_grid<double>(n); }
int tv1d_pcr_grid_f32(int m) { return pcr_grid<float>(m); }
int tv1d_pcr_grid_f64(int m) { return pcr_grid<double>(m); }
int tv1d_pdas_levels_grid_f32(int n) { return grid_for(pdas_levels<float>, 4, 0, n); }
int tv1d_pdas_levels_grid_f64(int n) { return grid_for(pdas_levels<double>, 5, 0, n); }

#ifdef K7_PHASE_MARKS
// Where the phase marks go on the current device (nullptr: none).
int tv1d_pdas_set_marks(void* marks) {
  return (int)cudaMemcpyToSymbol(phase_marks, &marks, sizeof(marks));
}
#endif

#define PDAS_ENTRY(SUFFIX, T)                                                                  \
  int tv1d_pdas_##SUFFIX(const void* v, const void* z0, const void* lam, T lam_value, T tol,   \
                         int n, int max_iters, int steps, int levels, int tile, int whole,     \
                         int group, void* x, void* z, void* gap, void* it, void* syncs,        \
                         void* scratch, void* act, void* flags, int grid, void* stream) {      \
    return launch_pdas<T>(true, v, z0, lam, lam_value, tol, n, max_iters, steps, levels, tile, \
                          whole, group, x, z, gap, it, syncs, scratch, act, flags, grid,       \
                          stream);                                                             \
  }                                                                                            \
  int tv1d_pdas_levels_##SUFFIX(const void* v, const void* z0, const void* lam, T lam_value,   \
                                T tol, int n, int max_iters, int steps, void* x, void* z,      \
                                void* gap, void* it, void* syncs, void* scratch, void* act,    \
                                void* flags, int grid, void* stream) {                         \
    return launch_pdas<T>(false, v, z0, lam, lam_value, tol, n, max_iters, steps, 0, 0, 0, 0,  \
                          x, z, gap, it, syncs, scratch, act, flags, grid, stream);            \
  }                                                                                            \
  int tv1d_pcr_##SUFFIX(const void* src, void* out, int m, int steps, int levels, int tile,    \
                        int whole, int group, void* scratch, int grid, void* stream) {         \
    return launch_pcr<T>(src, out, m, steps, levels, tile, whole, group, scratch, grid,        \
                         stream);                                                              \
  }

PDAS_ENTRY(f32, float)
PDAS_ENTRY(f64, double)

}  // extern "C"
