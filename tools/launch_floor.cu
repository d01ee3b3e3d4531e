// The launch floor of the short kernels (K1 glm_stats, K4 alpha_search, K7
// predict_tile), on no path of the package.  chip_smoke.py builds this file
// with nvcc and times launch_floor_empty with a kernel's own grid, through
// the same ctypes call and the same CUDA-event timing (behind a sleep
// kernel, so the launches are queued before the card reaches them) as the
// kernel itself: what a launch of that grid costs on the card with no work
// in it.  A kernel's time over this floor is what its own work adds.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// one launch of an empty kernel on a (gx, gy) grid of ``threads`` threads
extern "C" int launch_floor_empty(int gx, int gy, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
