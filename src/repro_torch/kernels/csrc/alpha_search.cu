// K4 alpha_search: the line search's candidate losses in one pass.
//
// Replaces src/repro/kernels/alpha_search.py::alpha_search_pallas (TPU
// Pallas).  For K step sizes alpha_k it computes
//   losses[k] = sum_i c_i * l(y_i, (xb_i + offset_i) + alpha_k * xdb_i)
// reading every example once for all K candidates.
//
// Bound on the card: bytes at large K-free sizes, but with K = 14 or 20
// candidates each example costs K loss evaluations (one or two
// transcendentals each), so at the main path's sizes the special-function
// units set the time; both bounds are far below a millisecond.  Design: the
// TPU kernel carried the (1, K) sums across its sequential grid in VMEM;
// blocks on the card run in no order, so each thread keeps up to KMAX
// running sums in registers over a grid-stride loop, each block reduces them
// (warp shuffles, then shared memory) to one partial per candidate, and a
// second one-block pass adds the partials in block order.  No atomics: the
// sums are the same from run to run.  blockIdx.y walks the candidates in
// groups of KMAX, so any K works.
#include <cuda_runtime.h>

#include "glm_family.cuh"

namespace {

constexpr int kKMax = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int F>
__global__ void __launch_bounds__(kThreads)
    alpha_search_partial(const float* __restrict__ y,
                         const float* __restrict__ xb,
                         const float* __restrict__ xdb,
                         const float* __restrict__ weights,
                         const float* __restrict__ offset,
                         const float* __restrict__ alphas, int K, long long n,
                         float* __restrict__ partials) {
  const int k0 = blockIdx.y * kKMax;
  const int kc = min(kKMax, K - k0);
  float a[kKMax];
  float acc[kKMax];
#pragma unroll
  for (int k = 0; k < kKMax; ++k) {
    a[k] = k < kc ? alphas[k0 + k] : 0.f;
    acc[k] = 0.f;
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float yi = y[i];
    float c = weights[i];
    float base = xb[i];
    if (offset != nullptr) base = base + offset[i];
    float d = xdb[i];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < kc) {
        // round the product and the sum apart, as the plain version does
        float m = __fadd_rn(base, __fmul_rn(a[k], d));
        acc[k] += repro::Stats<F>::loss(yi, m) * c;
      }
    }
  }
  __shared__ float red[kWarps][kKMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kKMax; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kc) {
    float tot = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) tot += red[wi][threadIdx.x];
    partials[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kKMax +
             threadIdx.x] = tot;
  }
}

__global__ void alpha_search_finish(const float* __restrict__ partials,
                                    int nblocks, int K,
                                    float* __restrict__ out) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int group = k / kKMax;
  int kk = k % kKMax;
  float tot = 0.f;
  for (int b = 0; b < nblocks; ++b)
    tot += partials[((long long)group * nblocks + b) * kKMax + kk];
  out[k] = tot;
}

}  // namespace

// partials: scratch of (ceil(K / 32) * nblocks * 32) floats from the caller.
extern "C" int repro_alpha_search(const float* y, const float* xb,
                                  const float* xdb, const float* weights,
                                  const float* offset, const float* alphas,
                                  int K, long long n, float* partials,
                                  int nblocks, float* out, int family,
                                  void* stream) {
  if (K <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nblocks, (K + kKMax - 1) / kKMax);
  switch (family) {
    case repro::kLogistic:
      alpha_search_partial<repro::kLogistic><<<grid, kThreads, 0, st>>>(
          y, xb, xdb, weights, offset, alphas, K, n, partials);
      break;
    case repro::kSquared:
      alpha_search_partial<repro::kSquared><<<grid, kThreads, 0, st>>>(
          y, xb, xdb, weights, offset, alphas, K, n, partials);
      break;
    case repro::kProbit:
      alpha_search_partial<repro::kProbit><<<grid, kThreads, 0, st>>>(
          y, xb, xdb, weights, offset, alphas, K, n, partials);
      break;
    case repro::kPoisson:
      alpha_search_partial<repro::kPoisson><<<grid, kThreads, 0, st>>>(
          y, xb, xdb, weights, offset, alphas, K, n, partials);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  alpha_search_finish<<<(K + 127) / 128, 128, 0, st>>>(partials, nblocks, K,
                                                        out);
  return (int)cudaGetLastError();
}
