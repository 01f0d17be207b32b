// An empty kernel: what one launch through the per-row kernels' ctypes path
// (ops/kernels/_rows.py) costs with no work, the floor that chip_smoke.py's
// phase 7a prints beside each per-row kernel's bound.  No dispatch calls it.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void empty() {}

}  // namespace

extern "C" {

// One block of 128 threads, as a one-row launch of a per-row kernel.
int row_launch_floor(void* stream) {
  empty<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
