// The ADMM x-update (Shooting) of every feature block, in one launch.
//
// Replaces no Pallas kernel: it is the port of the reference's
// src/repro/baselines/admm.py::_shooting_pass, a lax.fori_loop over a
// block's coordinates under a lax.scan over passes and a jax.vmap over
// blocks, which XLA compiles into one loop.  Eager PyTorch has no such loop
// (a Python loop would cost ~5 launches a coordinate).  For block m, each
// pass starts from a fresh residual r = A_m x - v_m and then, coordinate
// by coordinate in order,
//   rho_j = a_j . r - c_j x_j
//   x_j'  = S(-rho_j, lam1) / max(c_j + lam2, 1e-30)
//   r    += a_j (x_j' - x_j)
// with a_j the block's column j, c_j = |a_j|^2 and S the soft threshold.
//
// Bound on the card: each pass streams the block's columns once for the
// sweep and once for r = A x - v, so bytes; but every coordinate is a
// reduction over all n rows followed by a barrier, so the sweep is also a
// chain of p_block dependent reduction steps a pass.  Design: one thread
// block cluster per feature block (16 CTAs where the card schedules such
// a cluster, else 8, 4, 2 or 1; fewer where n is small), each CTA owning a
// fixed range of rows.  The columns are held column-major, (M, p_block, n),
// so a column's slice is contiguous and every load is coalesced.  r lives
// in the CTA's shared memory (25,000 rows = 100 KB a CTA at n = 400,000),
// or in a global scratch row where the slice would not fit.  A step is:
// the CTA's partial dot (warp shuffles, then the 32 warp sums by warp 0)
// into a shared slot kept by step parity; one cluster barrier; warp 0 of
// every CTA reads the C slots over distributed shared memory and adds them
// in the same order, so all CTAs compute the same x_j' bit for bit and
// keep their own copy of x (no global memory crosses CTAs); then one pass
// over the CTA's rows updates r with column j and takes the next partial
// dot with column j + 1.  Column j + 2's slice is prefetched into L2 a step
// ahead.  The r update is rounded as the reference's (a product, then a
// sum: no fused multiply-add); the dots are float32 sums in another order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;   // 32: warp 0 adds the warp sums
constexpr int kMaxCluster = 16;
// dynamic shared memory for r; the static part (x's staged chunk, the
// sums) takes about 4.3 KB of the block's 227 KB
constexpr int kMaxDynSmem = 220 * 1024;

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

template <bool kSmemR>
__global__ void __launch_bounds__(kThreads, 1)
    admm_shooting_kernel(const float* __restrict__ At,
                         const float* __restrict__ v,
                         const float* __restrict__ col_sq,
                         const float* __restrict__ x_in,
                         float* __restrict__ x_out,
                         float* __restrict__ x_cta,
                         float* __restrict__ r_glob, long long n, int pb,
                         int passes, float lam1, float lam2) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float r_smem[];
  __shared__ float xs[kThreads];         // a staged chunk of x
  __shared__ float warp_part[kWarps];
  __shared__ float slot[2];              // the CTA's partial dot, by parity
  __shared__ float s_delta;

  const long long per = (n + C - 1) / C;
  const long long lo = min(n, (long long)rank * per);
  const long long hi = min(n, lo + per);
  float* r = kSmemR ? r_smem : r_glob + (long long)m * n + lo;
  const float* A = At + (long long)m * pb * n;
  const float* vm = v + (long long)m * n;
  const float* csq = col_sq + (long long)m * pb;
  // this CTA's own copy of the block's x, updated in place
  float* x = x_cta + ((long long)m * kMaxCluster + rank) * pb;

  for (int k = tid; k < pb; k += kThreads) x[k] = x_in[(long long)m * pb + k];
  __syncthreads();

  unsigned step = 0;
  for (int pass = 0; pass < passes; ++pass) {
    // r = A x - v over the CTA's rows: x staged a chunk at a time, the sum
    // over j in order in one float32 accumulator (kept in r between chunks)
    for (long long i = lo + tid; i < hi; i += kThreads) r[i - lo] = 0.f;
    for (int c0 = 0; c0 < pb; c0 += kThreads) {
      const int cn = min(kThreads, pb - c0);
      if (tid < cn) xs[tid] = x[c0 + tid];
      __syncthreads();
      for (long long i = lo + tid; i < hi; i += kThreads) {
        const float* a = A + (long long)c0 * n + i;
        float acc = r[i - lo];
#pragma unroll 8
        for (int j = 0; j < cn; ++j) acc = fmaf(a[(long long)j * n], xs[j], acc);
        r[i - lo] = acc;
      }
      __syncthreads();
    }
    for (long long i = lo + tid; i < hi; i += kThreads)
      r[i - lo] = r[i - lo] - vm[i];

    float part = 0.f;
    for (long long i = lo + tid; i < hi; i += kThreads)
      part = fmaf(A[i], r[i - lo], part);
    for (int j = 0; j < pb; ++j, ++step) {
      if (j + 2 < pb) {
        const float* nx = A + (long long)(j + 2) * n;
        for (long long q = lo + 32LL * tid; q < hi; q += 32LL * kThreads)
          prefetch_l2(nx + q);
      }
      part = warp_sum(part);
      if (lane == 0) warp_part[warp] = part;
      __syncthreads();
      if (warp == 0) {
        const float b = warp_sum(warp_part[lane]);
        if (lane == 0) slot[step & 1] = b;
      }
      cluster.sync();
      if (warp == 0) {
        float tot = lane < C ? *cluster.map_shared_rank(&slot[step & 1], lane)
                             : 0.f;
        tot = warp_sum(tot);
        if (lane == 0) {
          const float xj = x[j];
          const float cj = csq[j];
          const float rho = __fsub_rn(tot, __fmul_rn(cj, xj));
          const float xn =
              __fdiv_rn(soft(-rho, lam1), fmaxf(__fadd_rn(cj, lam2), 1e-30f));
          x[j] = xn;
          s_delta = __fsub_rn(xn, xj);
        }
      }
      __syncthreads();
      if (j + 1 < pb) {   // the last step's r is rebuilt by the next pass
        const float delta = s_delta;
        const float* a = A + (long long)j * n;
        const float* an = a + n;
        part = 0.f;
#pragma unroll 4
        for (long long i = lo + tid; i < hi; i += kThreads) {
          const float ri = __fadd_rn(r[i - lo], __fmul_rn(a[i], delta));
          r[i - lo] = ri;
          part = fmaf(an[i], ri, part);
        }
      }
    }
    __syncthreads();   // x's last entries before the next pass stages them
  }
  if (rank == 0)
    for (int k = tid; k < pb; k += kThreads) x_out[(long long)m * pb + k] = x[k];
  cluster.sync();      // no CTA leaves while another may read its slots
}

const repro::KernelSlot kSlots[] = {
    {(const void*)admm_shooting_kernel<false>, "admm_shooting_kernel<false>"},
    {(const void*)admm_shooting_kernel<true>, "admm_shooting_kernel<true>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

const void* kernel_of(bool smem_r) {
  return smem_r ? (const void*)admm_shooting_kernel<true>
                : (const void*)admm_shooting_kernel<false>;
}

// The cluster size and where r lives, for n rows: the largest of 16, 8, 4,
// 2, 1 that has a CTA a kThreads rows (1 always does) and that the card
// can schedule; r in shared memory where a CTA's rows fit there.
cudaError_t plan(long long n, int& C, bool& smem_r, size_t& smem) {
  static const int sizes[] = {16, 8, 4, 2, 1};
  cudaError_t err = cudaSuccess;
  for (int c : sizes) {
    if (c > 1 && n < (long long)c * kThreads) continue;
    const long long per = (n + c - 1) / c;
    const bool s = per * 4 <= kMaxDynSmem;
    const void* fn = kernel_of(s);
    if ((err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMaxDynSmem)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
        cudaSuccess)
      return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = s ? (size_t)per * 4 : 0;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();   // this size is refused; try the next
      continue;
    }
    if (clusters >= 1) {
      C = c;
      smem_r = s;
      smem = cfg.dynamicSmemBytes;
      return cudaSuccess;
    }
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

}  // namespace

// x_out (M, pb) = x after `passes` Shooting passes of every block.  At
// (M, pb, n) column-major blocks, v (M, n), col_sq (M, pb), x_in (M, pb);
// x_cta (M, 16, pb) scratch; r_glob (M, n) scratch, used only where r does
// not fit in shared memory (repro_admm_shooting_plan says).
extern "C" int repro_admm_shooting(const float* At, const float* v,
                                   const float* col_sq, const float* x_in,
                                   float* x_out, float* x_cta, float* r_glob,
                                   int M, int pb, long long n, int passes,
                                   float lam1, float lam2, void* stream) {
  if (M < 1 || pb < 1 || n < 1 || passes < 0) return (int)cudaErrorInvalidValue;
  int C = 1;
  bool s = true;
  size_t smem = 0;
  cudaError_t err = plan(n, C, s, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(M * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = repro::note_launch(kSlots, kMax, kernel_of(s), smem,
                                kThreads)) != cudaSuccess)
    return (int)err;
  err = s ? cudaLaunchKernelEx(&cfg, admm_shooting_kernel<true>, At, v, col_sq,
                               x_in, x_out, x_cta, r_glob, n, pb, passes, lam1,
                               lam2)
          : cudaLaunchKernelEx(&cfg, admm_shooting_kernel<false>, At, v,
                               col_sq, x_in, x_out, x_cta, r_glob, n, pb,
                               passes, lam1, lam2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of a launch over n rows: the cluster size (CTAs a block) and
// whether r lives in shared memory; a CUDA error code (0 on success).
extern "C" int repro_admm_shooting_plan(long long n, int* cluster,
                                        int* r_in_smem) {
  int C = 1;
  bool s = true;
  size_t smem = 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = plan(n, C, s, smem);
  if (err != cudaSuccess) return (int)err;
  *cluster = C;
  *r_in_smem = s ? 1 : 0;
  return 0;
}

REPRO_RESOURCES_ENTRY(admm_shooting)
