// Empty kernels: what one launch through the per-row kernels' ctypes path
// (ops/kernels/_rows.py) costs with no work, the floor that chip_smoke.py's
// phase 7a prints beside each per-row kernel's bound; and an empty
// cooperative kernel that only waits at k grid syncs, at the grid a
// cooperative kernel takes (the TV-1D PDAS, tv1d_pdas.cu), which gives what
// one grid.sync() costs on the card.  No dispatch calls them.
//
// Plain C interface for ctypes; each entry returns its CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void empty() {}

__global__ void syncs(int k) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < k; ++i) grid.sync();
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

}  // extern "C"
