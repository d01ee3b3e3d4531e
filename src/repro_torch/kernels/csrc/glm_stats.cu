// K1 glm_stats: per-example GLM link statistics in one pass.
//
// Replaces src/repro/kernels/glm_stats.py::glm_stats_pallas (TPU Pallas).
// For each example i it writes
//   loss_i = c_i * l(y_i, m_i),  s_i = -c_i * dl/dm,  w_i = c_i * d2l/dm2
// at m_i = xb_i + offset_i, where c_i is the observation weight (sample
// weight x fold mask x row padding, all one multiply).
//
// Bound on the card: bytes.  Four (n,) f32 inputs in (five with an offset)
// and three out, ~10 flops and one or two transcendentals per example, far
// below the H100's ratio of flops to bytes.  Design: one thread per example
// over a grid-stride loop; every load and store is a coalesced 4-byte access
// of neighbouring threads, and the three outputs leave in the same pass, so
// the data cross device memory once.  The TPU's (R, 128) lane packing and
// its padding mask are gone: the kernel takes flat (n,) vectors.
#include <cuda_runtime.h>

#include "glm_family.cuh"

namespace {

template <int F>
__global__ void glm_stats_kernel(const float* __restrict__ y,
                                 const float* __restrict__ xb,
                                 const float* __restrict__ weights,
                                 const float* __restrict__ offset,
                                 float* __restrict__ loss,
                                 float* __restrict__ s,
                                 float* __restrict__ w, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float m = xb[i];
    if (offset != nullptr) m = m + offset[i];
    float l, si, wi;
    repro::Stats<F>::all(y[i], m, l, si, wi);
    float c = weights[i];
    loss[i] = l * c;
    s[i] = si * c;
    w[i] = wi * c;
  }
}

}  // namespace

extern "C" int repro_glm_stats(const float* y, const float* xb,
                               const float* weights, const float* offset,
                               float* loss, float* s, float* w, long long n,
                               int family, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case repro::kLogistic:
      glm_stats_kernel<repro::kLogistic><<<(int)blocks, threads, 0, st>>>(
          y, xb, weights, offset, loss, s, w, n);
      break;
    case repro::kSquared:
      glm_stats_kernel<repro::kSquared><<<(int)blocks, threads, 0, st>>>(
          y, xb, weights, offset, loss, s, w, n);
      break;
    case repro::kProbit:
      glm_stats_kernel<repro::kProbit><<<(int)blocks, threads, 0, st>>>(
          y, xb, weights, offset, loss, s, w, n);
      break;
    case repro::kPoisson:
      glm_stats_kernel<repro::kPoisson><<<(int)blocks, threads, 0, st>>>(
          y, xb, weights, offset, loss, s, w, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
