// One epoch of distributed online truncated gradient: every shard's
// sequential pass over its rows, in one launch.
//
// Replaces no Pallas kernel: it is the port of the reference's
// src/repro/baselines/online_tg.py::_epoch, a lax.scan over a shard's rows
// under a jax.vmap over shards, which XLA compiles into one loop (a Python
// loop would cost ~6 launches a row: ~18 M for 30 epochs at the paper's
// epsilon shape).  Shard m walks its rows i in order from the shared start
// w0 at global step t0:
//   eta = lr / t^power;  m_i = x_i . w;  s = the family's -dl/dm at m_i
//   w += (eta s) x_i;  w *= 1 - eta lam2;  w = S(w, eta lam1);  t += 1
// (t in float32, as the reference's scan carries it), and writes its w;
// the wrapper averages the shards.
//
// Bound on the card: one epoch reads X once (bytes), but each shard is a
// chain of n_per dependent row steps and only M chains run: the
// algorithm's shape (the reference's vmap of M scans has it too).  Design:
// one CTA of 256 threads a shard; thread k owns the features k, k + 256,
// ..., so the weight update needs no barrier and only the row's dot is
// shared: warp shuffles, the 8 warp sums into a shared slot kept by row
// parity, one __syncthreads a row, and every thread adds the 8 sums in the
// same order.  w lives in shared memory (up to 56,320 features) or, past
// that, in the shard's row of the output.  Rows kAhead ahead are
// prefetched into L2.  The family's s comes from glm_family.cuh (K1's
// formulas); the update is rounded as the reference's (products and sums
// apart: no fused multiply-add), the dot is a float32 sum in another order.
#include <cuda_runtime.h>
#include <math.h>

#include "glm_family.cuh"
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDynSmem = 220 * 1024;   // w in shared memory up to here
constexpr int kAhead = 8;                 // rows prefetched ahead

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: fp addition commutes, so every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float soft(float z, float a) {
  // sign(z) max(|z| - a, 0), NaN kept
  if (isnan(z)) return z;
  const float t = fmaxf(fabsf(z) - a, 0.f);
  return z > 0.f ? t : (z < 0.f ? -t : 0.f);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <int F, bool kSmemW>
__global__ void __launch_bounds__(kThreads)
    online_tg_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ w0, float* __restrict__ w_out,
                     long long n_per, int p, float t0, float lr, float power,
                     float lam1, float lam2) {
  extern __shared__ float w_smem[];
  __shared__ float red[2][kWarps];   // the warp sums, by row parity
  const int m = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w = kSmemW ? w_smem : w_out + (long long)m * p;
  for (int k = tid; k < p; k += kThreads) w[k] = w0[k];
  const float* Xm = X + (long long)m * n_per * p;
  const float* ym = y + (long long)m * n_per;

  float t = t0;
  for (long long i = 0; i < n_per; ++i) {
    const float* x = Xm + i * p;
    if (i + kAhead < n_per) {
      const float* nx = x + (long long)kAhead * p;
      for (int q = 32 * tid; q < p; q += 32 * kThreads) prefetch_l2(nx + q);
    }
    float part = 0.f;
    for (int k = tid; k < p; k += kThreads) part = fmaf(x[k], w[k], part);
    part = warp_sum(part);
    if (lane == 0) red[i & 1][warp] = part;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) dot += red[i & 1][q];
    const float eta = __fdiv_rn(lr, powf(t, power));
    float l, s, c;
    repro::Stats<F>::all(ym[i], dot, l, s, c);
    const float es = __fmul_rn(eta, s);
    const float shrink = __fsub_rn(1.f, __fmul_rn(eta, lam2));
    const float thr = __fmul_rn(eta, lam1);
    for (int k = tid; k < p; k += kThreads) {
      const float u = __fadd_rn(w[k], __fmul_rn(es, x[k]));
      w[k] = soft(__fmul_rn(u, shrink), thr);
    }
    t = __fadd_rn(t, 1.f);
  }
  if (kSmemW)
    for (int k = tid; k < p; k += kThreads) w_out[(long long)m * p + k] = w[k];
}

template <int F>
const void* kernel_for(bool smem_w) {
  return smem_w ? (const void*)online_tg_kernel<F, true>
                : (const void*)online_tg_kernel<F, false>;
}

#define ONLINE_TG(F, W) \
  {(const void*)online_tg_kernel<F, W>, "online_tg_kernel<" #F "," #W ">"}

const repro::KernelSlot kSlots[] = {
    ONLINE_TG(0, false), ONLINE_TG(0, true), ONLINE_TG(1, false),
    ONLINE_TG(1, true),  ONLINE_TG(2, false), ONLINE_TG(2, true),
    ONLINE_TG(3, false), ONLINE_TG(3, true),
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

const void* kernel_of(int family, bool smem_w) {
  switch (family) {
    case repro::kLogistic: return kernel_for<repro::kLogistic>(smem_w);
    case repro::kSquared: return kernel_for<repro::kSquared>(smem_w);
    case repro::kProbit: return kernel_for<repro::kProbit>(smem_w);
    case repro::kPoisson: return kernel_for<repro::kPoisson>(smem_w);
    default: return nullptr;
  }
}

}  // namespace

// w_out (M, p): each shard's w after its pass over its n_per rows.
// X (M, n_per, p) and y (M, n_per) the shards' rows in order, w0 (p,).
extern "C" int repro_online_tg(const float* X, const float* y,
                               const float* w0, float* w_out, int M,
                               long long n_per, int p, float t0, float lr,
                               float power, float lam1, float lam2,
                               int family, void* stream) {
  if (M < 1 || n_per < 0 || p < 1) return (int)cudaErrorInvalidValue;
  const bool smem_w = (long long)p * 4 <= kMaxDynSmem;
  const void* fn = kernel_of(family, smem_w);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem_w && (err = cudaFuncSetAttribute(
                     fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     kMaxDynSmem)) != cudaSuccess)
    return (int)err;
  const size_t smem = smem_w ? (size_t)p * 4 : 0;
  void* args[] = {&X, &y, &w0, &w_out, &n_per, &p, &t0, &lr, &power,
                  &lam1, &lam2};
  if ((err = repro::note_launch(kSlots, kMax, fn, smem, kThreads)) !=
      cudaSuccess)
    return (int)err;
  err = cudaLaunchKernel(fn, dim3(M), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most features whose w the kernel keeps in shared memory.
extern "C" int repro_online_tg_smem_features() { return kMaxDynSmem / 4; }

REPRO_RESOURCES_ENTRY(online_tg)
