// K1 glm_stats: per-example GLM link statistics in one pass.
//
// Replaces src/repro/kernels/glm_stats.py::glm_stats_pallas (TPU Pallas).
// For each example i it writes
//   loss_i = c_i * l(y_i, m_i),  s_i = -c_i * dl/dm,  w_i = c_i * d2l/dm2
// at m_i = xb_i + offset_i, where c_i is the observation weight (sample
// weight x fold mask x row padding, all one multiply).
//
// Bound on the card: bytes.  Four (n,) f32 inputs in (three without an
// offset) and three out, 28 bytes an example, against one call of
// Stats<F>::all (tens of fp32-pipe instructions; tools/loss_floor.cu
// times it) -- at the main path's n of 131,072 and 400,000 the launch and
// one trip to device memory are most of the time.  Design: the rows go in
// quads, one float4 of each vector (loads and stores of 16 bytes a
// thread, neighbouring threads on neighbouring quads), where every vector
// is 16-byte aligned; else, and for the n % 4 rows past the last whole
// quad, element by element.  The grid is one wave at most (the occupancy
// API times the SM count) and no larger than a block per kQuadsPerThread
// quads a thread: at the main path's n each thread takes one quad, and so
// every load of the pass is in flight at once (two quads a thread, half
// the blocks, was 4-11% slower on the card: tools/kernel_forms.py); past
// one wave a thread loads the vectors of two quads before it computes
// either.  Every element is computed by the same operations as before:
// m = xb + offset, Stats<F>::all (the probit tail of the Pallas body
// included), then each output times c.  The TPU's (R, 128) lane packing
// and its padding mask are gone: the kernel takes flat (n,) vectors.
#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_family.cuh"
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuadsPerThread = 1;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 ld4(const float* p, long long q) {
  return *reinterpret_cast<const float4*>(p + 4 * q);
}

__device__ __forceinline__ void st4(float* p, long long q, float4 v) {
  *reinterpret_cast<float4*>(p + 4 * q) = v;
}

template <int F>
__device__ __forceinline__ void row(float y, float m, float c, float& l,
                                    float& s, float& w) {
  float li, si, wi;
  repro::Stats<F>::all(y, m, li, si, wi);
  l = li * c;
  s = si * c;
  w = wi * c;
}

// the four rows of quad q from its loaded vectors
template <int F>
__device__ __forceinline__ void quad(float4 y, float4 m, float4 c,
                                     float4 o, bool has_offset, long long q,
                                     float* __restrict__ loss,
                                     float* __restrict__ s,
                                     float* __restrict__ w) {
  if (has_offset) {
    m.x = m.x + o.x;
    m.y = m.y + o.y;
    m.z = m.z + o.z;
    m.w = m.w + o.w;
  }
  float4 l, si, wi;
  row<F>(y.x, m.x, c.x, l.x, si.x, wi.x);
  row<F>(y.y, m.y, c.y, l.y, si.y, wi.y);
  row<F>(y.z, m.z, c.z, l.z, si.z, wi.z);
  row<F>(y.w, m.w, c.w, l.w, si.w, wi.w);
  st4(loss, q, l);
  st4(s, q, si);
  st4(w, q, wi);
}

// vec: every pointer 16-byte aligned; then the n / 4 whole quads go by
// float4, two a thread at a time, and the rows past them one by one
template <int F>
__global__ void __launch_bounds__(kThreads)
    glm_stats_kernel(const float* __restrict__ y,
                     const float* __restrict__ xb,
                     const float* __restrict__ weights,
                     const float* __restrict__ offset,
                     float* __restrict__ loss, float* __restrict__ s,
                     float* __restrict__ w, long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nq = vec ? n / 4 : 0;
  const bool has_offset = offset != nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = t0; q < nq; q += 2 * stride) {
    const long long q2 = q + stride;
    const bool two = q2 < nq;
    const float4 y0 = ld4(y, q), m0 = ld4(xb, q), c0 = ld4(weights, q);
    const float4 o0 = has_offset ? ld4(offset, q) : zero;
    float4 y1 = zero, m1 = zero, c1 = zero, o1 = zero;
    if (two) {
      y1 = ld4(y, q2);
      m1 = ld4(xb, q2);
      c1 = ld4(weights, q2);
      if (has_offset) o1 = ld4(offset, q2);
    }
    quad<F>(y0, m0, c0, o0, has_offset, q, loss, s, w);
    if (two) quad<F>(y1, m1, c1, o1, has_offset, q2, loss, s, w);
  }
  for (long long i = 4 * nq + t0; i < n; i += stride) {
    float m = xb[i];
    if (offset != nullptr) m = m + offset[i];
    row<F>(y[i], m, weights[i], loss[i], s[i], w[i]);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

const repro::KernelSlot kSlots[] = {
    {(const void*)glm_stats_kernel<repro::kLogistic>, "glm_stats_kernel<0>"},
    {(const void*)glm_stats_kernel<repro::kSquared>, "glm_stats_kernel<1>"},
    {(const void*)glm_stats_kernel<repro::kProbit>, "glm_stats_kernel<2>"},
    {(const void*)glm_stats_kernel<repro::kPoisson>, "glm_stats_kernel<3>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

const void* kernel_of(int family) {
  switch (family) {
    case repro::kLogistic:
      return (const void*)glm_stats_kernel<repro::kLogistic>;
    case repro::kSquared:
      return (const void*)glm_stats_kernel<repro::kSquared>;
    case repro::kProbit:
      return (const void*)glm_stats_kernel<repro::kProbit>;
    case repro::kPoisson:
      return (const void*)glm_stats_kernel<repro::kPoisson>;
    default: return nullptr;
  }
}

// blocks of the launch for n rows: one wave (the occupancy API times the
// SM count, looked up at the first launch of each device and family), at
// most one block per kThreads x kQuadsPerThread quads
cudaError_t grid_of(int family, long long n, int& nblocks) {
  static long long waves[kMaxDevices][4];      // 0: not looked up yet
  const void* fn = kernel_of(family);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long& wave = waves[dev][family];
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, kThreads, 0)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    wave = (long long)sms * per_sm;
  }
  const long long per_block = (long long)kThreads * kQuadsPerThread;
  const long long nq = (n + 3) / 4;
  nblocks = (int)max(1LL, min(wave, (nq + per_block - 1) / per_block));
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_glm_stats(const float* y, const float* xb,
                               const float* weights, const float* offset,
                               float* loss, float* s, float* w, long long n,
                               int family, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  int nblocks = 0;
  cudaError_t err = grid_of(family, n, nblocks);
  if (err != cudaSuccess) return (int)err;
  int vec = aligned16(y) && aligned16(xb) && aligned16(weights) &&
            aligned16(offset) && aligned16(loss) && aligned16(s) &&
            aligned16(w);
  void* args[] = {&y, &xb, &weights, &offset, &loss, &s, &w, &n, &vec};
  err = repro::note_launch(kSlots, kMax, kernel_of(family), 0, kThreads);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel_of(family), dim3(nblocks), dim3(kThreads),
                         args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The blocks of the launch repro_glm_stats makes for n rows of the family
// on the current device (kThreads threads each), or -1 on a CUDA error.
extern "C" int repro_glm_stats_grid(long long n, int family) {
  int nblocks = 0;
  if (n < 0 || grid_of(family, n, nblocks) != cudaSuccess) return -1;
  return nblocks;
}

REPRO_RESOURCES_ENTRY(glm_stats)

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
