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
// solve (ceil(log2 m) steps, m = n - 1); six trial steps of the projected
// line search and their changes of J = ||D^T z - v||^2; the full step, the
// argmin, or the incumbent where every trial rises; `settled` (the active
// set repeats and the full step descends); the duality gap.  The loop goes
// on while not settled, the gap is above gap_tol and fewer than max_iters
// rounds ran; every block reads that test itself.
//
// Passes, each over the row grid-strided, separated by grid.sync(): the
// round's start (g, act, the system), each PCR step (the last writes the
// solve's z_new), the trials (partial sums), the step and the gap (partial
// sums), and the stop test, which every block evaluates on the same
// partials: steps + 3 syncs a round.  Reductions run in a fixed order (a
// block's elements in grid-stride order, a warp butterfly, the warps in
// order; then every block sums the blocks' partials the same way), so every
// block holds the same bits and two runs give the same result.  The
// elementwise arithmetic repeats the plain version's operations in its
// order (--fmad=false): one PCR solve equals pcr_tridiag_solve's bitwise
// (tv1d_pcr, the second entry, runs it alone); only the sums (E g, E Q E,
// the gap, dv.dv, ||v||^2) round in another order than torch's.
//
// Bound: a round reads and writes each of about 15 arrays of m a few times
// (L2-resident at n = 100,000: 6 MB in f32), so it is bound by its chain of
// steps + 3 grid syncs, a round's passes each a few dependent loads long;
// chip_smoke.py's phase 7a times an empty cooperative kernel with the same
// syncs at the same grid (launch_floor.cu) and states the bound as syncs x
// that cost x rounds.
//
// Mapping: THREADS threads a block, as many blocks as the card keeps
// resident (cooperative launch) or as the row needs, whichever is fewer;
// scratch (12 arrays of m, the partials, act, the flags) is allocated by the
// wrapper.  Entries: tv1d_pdas_{f32,f64}, tv1d_pcr_{f32,f64} and the grid
// each takes; plain C interface for ctypes, each launch entry returns its
// CUDA error code.

#include <cooperative_groups.h>

#include "row_loops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rowloops;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TRIALS = 6;
// partial sums of the trial pass: E.g and E.QE for each trial
constexpr int PART = 2 * TRIALS;

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
  T* x;
  T* z_out;
  T* gap_out;
  int* it_out;
  T* z[2];          // the dual, ping-ponged by the step pass
  T* zn;            // the PCR solve
  T* g;             // D D^T z - dv
  Sys<T> sys[2];    // PCR's ping-pong
  signed char* act; // the active set
  T* part;          // per-block partial sums
  int* flags;       // per-block "the active set changed", by round parity
};

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

// pcr_tridiag_solve: `steps` steps of parallel cyclic reduction from src0,
// ping-ponging through s1 and s0 (step k writes s1 for even k, s0 for odd
// k, and reads what step k - 1 wrote), the last step writing d / b to out.
// Out-of-range neighbours are identity rows (b = 1, a = c = d = 0).  Each
// element's operations are the plain version's, in its order.
template <typename T>
__device__ void pcr(const Sys<T>& src0, const Sys<T>& s0, const Sys<T>& s1, T* out, int m,
                    int steps, cg::grid_group& grid) {
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
    grid.sync();
  }
}

// (D^T w)_k = -w_k + w_{k-1} (tv1d._diff_t: the cat of -w and a zero, plus
// the cat of a zero and w), for k in [0, m]; wl = w_{k-1}, wk = w_k.
template <typename T> __device__ __forceinline__ T dt(T wl, T wk, int k, int m) {
  return (k < m ? -wk : T(0)) + (k > 0 ? wl : T(0));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pdas_kernel(Pdas<T> p) {
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
  grid.sync();
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
    if (threadIdx.x == 0) p.flags[(it & 1) * gridDim.x + blockIdx.x] = changed;
    grid.sync();

    pcr(src0, p.sys[0], p.sys[1], p.zn, m, p.steps, grid);

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
    put_partial<PART>(part_t, s);
    grid.sync();
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
    put_partial<1>(part_g, gs);
    grid.sync();

    // the stop test, in every block on the same partials
    grid_sum<1>(part_g, gs, sh);
    int any = 0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS)
      any |= p.flags[(it & 1) * gridDim.x + j];
    any = __syncthreads_or(any);
    const bool settled = !any && full_ok;
    ++it;
    cur = 1 - cur;
    const bool go = !settled && gs[0] > gap_tol;
    if (it >= p.max_iters || !go) break;
  }

  // x = v - D^T z and the gap of z = box(z)
  const T* z = p.z[cur];
  T fs[1] = {T(0)};
  for (int i = first; i < n; i += stride) {
    const T wi = i < m ? box(z[i], lam) : T(0);
    const T wl = i > 0 ? box(z[i - 1], lam) : T(0);
    const T xi = v[i] - dt(wl, wi, i, m);
    p.x[i] = xi;
    if (i < m) {
      const T wr = i + 1 < m ? box(z[i + 1], lam) : T(0);
      p.z_out[i] = wi;
      const T d = (v[i + 1] - dt(wi, wr, i + 1, m)) - xi;
      fs[0] += lam * fabs(d) - wi * d;
    }
  }
  block_sum<1>(fs, sh);
  put_partial<1>(part_f, fs);
  grid.sync();
  if (blockIdx.x == 0) {
    grid_sum<1>(part_f, fs, sh);
    if (threadIdx.x == 0) {
      *p.gap_out = fs[0];
      *p.it_out = it;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pcr_kernel(Sys<T> src, Sys<T> s0, Sys<T> s1, T* out,
                                                      int m, int steps) {
  cg::grid_group grid = cg::this_grid();
  pcr(src, s0, s1, out, m, steps, grid);
}

// Blocks of THREADS resident on the current device for `kernel`, cached.
template <typename K> int resident(K kernel, int slot) {
  static int cache[4][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  int& c = cache[slot][dev];
  if (c == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    c = per_sm * sms;
  }
  return c;
}

// The grid for a row of `len` elements: the resident blocks or the row's,
// whichever is fewer (0 when the occupancy query fails).
template <typename K> int grid_for(K kernel, int slot, int len) {
  const int most = resident(kernel, slot);
  const int need = (len + THREADS - 1) / THREADS;
  return most < need ? most : (need > 0 ? need : 1);
}

template <typename T>
int launch_pdas(const void* v, const void* z0, const void* lam_p, T lam_value, T tol, int n,
                int max_iters, int steps, void* x, void* z_out, void* gap, void* it,
                void* scratch, void* act, void* flags, int grid, void* stream) {
  const long long m = n - 1;
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
  p.x = static_cast<T*>(x);
  p.z_out = static_cast<T*>(z_out);
  p.gap_out = static_cast<T*>(gap);
  p.it_out = static_cast<int*>(it);
  p.z[0] = s;
  p.z[1] = s + m;
  p.zn = s + 2 * m;
  p.g = s + 3 * m;
  p.sys[0] = Sys<T>{s + 4 * m, s + 5 * m, s + 6 * m, s + 7 * m};
  p.sys[1] = Sys<T>{s + 8 * m, s + 9 * m, s + 10 * m, s + 11 * m};
  p.part = s + 12 * m;
  p.act = static_cast<signed char*>(act);
  p.flags = static_cast<int*>(flags);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)pdas_kernel<T>, grid, THREADS,
                                                    args, 0, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_pcr(const void* a, const void* b, const void* c, const void* d, void* out, int m,
               int steps, void* scratch, int grid, void* stream) {
  T* s = static_cast<T*>(scratch);
  const long long mm = m;
  Sys<T> src{const_cast<T*>(static_cast<const T*>(a)), const_cast<T*>(static_cast<const T*>(b)),
             const_cast<T*>(static_cast<const T*>(c)), const_cast<T*>(static_cast<const T*>(d))};
  Sys<T> s0{s, s + mm, s + 2 * mm, s + 3 * mm};
  Sys<T> s1{s + 4 * mm, s + 5 * mm, s + 6 * mm, s + 7 * mm};
  T* o = static_cast<T*>(out);
  void* args[] = {&src, &s0, &s1, &o, &m, &steps};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)pcr_kernel<T>, grid, THREADS,
                                                    args, 0, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch the PDAS entry takes: 12 arrays of n - 1 and 16 partials a
// block of T; n - 1 bytes of act; 2 ints a block of flags.
int tv1d_pdas_threads() { return THREADS; }
int tv1d_pdas_grid_f32(int n) { return grid_for(pdas_kernel<float>, 0, n); }
int tv1d_pdas_grid_f64(int n) { return grid_for(pdas_kernel<double>, 1, n); }
int tv1d_pcr_grid_f32(int m) { return grid_for(pcr_kernel<float>, 2, m); }
int tv1d_pcr_grid_f64(int m) { return grid_for(pcr_kernel<double>, 3, m); }

#define PDAS_ENTRY(SUFFIX, T)                                                               \
  int tv1d_pdas_##SUFFIX(const void* v, const void* z0, const void* lam, T lam_value, T tol, \
                         int n, int max_iters, int steps, void* x, void* z, void* gap,        \
                         void* it, void* scratch, void* act, void* flags, int grid,           \
                         void* stream) {                                                     \
    return launch_pdas<T>(v, z0, lam, lam_value, tol, n, max_iters, steps, x, z, gap, it,     \
                          scratch, act, flags, grid, stream);                                \
  }                                                                                          \
  int tv1d_pcr_##SUFFIX(const void* a, const void* b, const void* c, const void* d,          \
                        void* out, int m, int steps, void* scratch, int grid, void* stream) { \
    return launch_pcr<T>(a, b, c, d, out, m, steps, scratch, grid, stream);                  \
  }

PDAS_ENTRY(f32, float)
PDAS_ENTRY(f64, double)

}  // extern "C"
