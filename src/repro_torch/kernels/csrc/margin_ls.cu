// K6 margin_ls: fused launch 2 of the Jacobi superstep on a dense design --
// the margin delta and the loss of every line-search candidate in one pass.
//
// Replaces src/repro/kernels/superstep_tile.py::margin_ls_pallas (TPU
// Pallas).  With c_i the observation weight and b_i = xb_i + offset_i:
//   xdb_i     = sum_j X_ij dbeta_j
//   losses[k] = sum_i c_i * l(y_i, b_i + alpha_k xdb_i)
// for all K candidates (294 at the default line search: the unit step, the
// 13-point grid and every Armijo backtracking chain).
//
// Bound on the card: bytes.  X is read once (3.3 GB at 400,000 x 2,048,
// about 1 ms at 3.35 TB/s); the product is 2 flops per element and each
// candidate costs one or two transcendentals per row, both far below that.
//
// Design.  The TPU kernel walked a (row block, tile) grid and kept the
// block's xdb in VMEM for the candidate sweep.  Here one block takes a
// range of rows: it stages dbeta in shared memory in 2,048-column chunks,
// and each warp forms the dot products of its rows with 16-byte loads of
// neighbouring columns (X read in place, row-major) and a shuffle sum.  The
// block's xdb is written out once and kept in shared memory; the candidate
// pass then reads it from there, each thread summing the losses of its rows
// for up to 32 candidates at a time in registers (as K4 does), reduced per
// block to one partial per candidate.  A finishing pass adds each
// candidate's partials with one warp: every lane a strided run of blocks,
// then a shuffle tree.  The partials are near-equal (each block's rows are
// alike), and one running sum over hundreds of them would drift by up to
// blocks x 6e-8 of the sum; the tree holds it near 1e-6.  No atomics: the
// same sums every run.
#include <cuda_runtime.h>

#include "glm_family.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 1024;
constexpr int kChunk = 2048;   // dbeta columns staged per step
constexpr int kKMax = 32;      // candidates summed per pass over the rows

template <int F>
__global__ void __launch_bounds__(kThreads)
    margin_ls_partial(const float* __restrict__ X, long long n, int p,
                      const float* __restrict__ dbeta,
                      const float* __restrict__ y,
                      const float* __restrict__ xb,
                      const float* __restrict__ weights,
                      const float* __restrict__ offset,
                      const float* __restrict__ alphas, int K,
                      float* __restrict__ xdb,
                      float* __restrict__ partials) {
  __shared__ __align__(16) float d_s[kChunk];
  __shared__ float xdb_s[kRowsPerBlock];
  __shared__ float red[kWarps][kKMax];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  const int nrows = (int)min((long long)kRowsPerBlock, n - r0);

  for (int r = tid; r < kRowsPerBlock; r += kThreads) xdb_s[r] = 0.f;
  for (int c0 = 0; c0 < p; c0 += kChunk) {
    const int cw = min(kChunk, p - c0);
    __syncthreads();
    for (int c = tid; c < cw; c += kThreads) d_s[c] = dbeta[c0 + c];
    __syncthreads();
    for (int r = warp; r < nrows; r += kWarps) {
      const float* row = X + (r0 + r) * p + c0;
      float acc = 0.f;
      for (int c = lane * 4; c < cw; c += 128) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(row + c));
        const float4 dv = *reinterpret_cast<const float4*>(&d_s[c]);
        acc += xv.x * dv.x + xv.y * dv.y + xv.z * dv.z + xv.w * dv.w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) xdb_s[r] += acc;
    }
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += kThreads) xdb[r0 + r] = xdb_s[r];

  for (int k0 = 0; k0 < K; k0 += kKMax) {
    const int kc = min(kKMax, K - k0);
    float a[kKMax];
    float acc[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      a[k] = k < kc ? alphas[k0 + k] : 0.f;
      acc[k] = 0.f;
    }
    for (int r = tid; r < nrows; r += kThreads) {
      const long long i = r0 + r;
      const float yi = y[i];
      const float c = weights[i];
      float base = xb[i];
      if (offset != nullptr) base = base + offset[i];
      const float d = xdb_s[r];
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k < kc) {
          // round the product and the sum apart, as the plain version does
          const float m = __fadd_rn(base, __fmul_rn(a[k], d));
          acc[k] += repro::Stats<F>::loss(yi, m) * c;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      float v = acc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (tid < kc) {
      float tot = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) tot += red[wi][tid];
      partials[(long long)blockIdx.x * K + k0 + tid] = tot;
    }
    __syncthreads();
  }
}

// one warp per candidate: blockDim.x = 32 * kWarps, candidate k = the
// block's warp index
__global__ void margin_ls_finish(const float* __restrict__ partials,
                                 int nblocks, int K,
                                 float* __restrict__ losses) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;
  float tot = 0.f;
  for (int b = lane; b < nblocks; b += 32)
    tot += partials[(long long)b * K + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  if (lane == 0) losses[k] = tot;
}

}  // namespace

// X: (n, p) row-major, p a multiple of 4 (16-byte rows); dbeta (p,); y, xb,
// weights, offset (may be null), xdb: (n,); alphas, losses: (K,).  Scratch
// partials (ceil(n / 1024) * K) from the caller.
extern "C" int repro_margin_ls(const float* X, long long n, int p,
                               const float* dbeta, const float* y,
                               const float* xb, const float* weights,
                               const float* offset, const float* alphas,
                               int K, float* xdb, float* partials,
                               float* losses, int family, void* stream) {
  if (n <= 0 || p <= 0 || p % 4 != 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (int)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  switch (family) {
    case repro::kLogistic:
      margin_ls_partial<repro::kLogistic><<<nblocks, kThreads, 0, st>>>(
          X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb, partials);
      break;
    case repro::kSquared:
      margin_ls_partial<repro::kSquared><<<nblocks, kThreads, 0, st>>>(
          X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb, partials);
      break;
    case repro::kProbit:
      margin_ls_partial<repro::kProbit><<<nblocks, kThreads, 0, st>>>(
          X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb, partials);
      break;
    case repro::kPoisson:
      margin_ls_partial<repro::kPoisson><<<nblocks, kThreads, 0, st>>>(
          X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb, partials);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  margin_ls_finish<<<(K + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      partials, nblocks, K, losses);
  return (int)cudaGetLastError();
}
