// K4 alpha_search: the line search's candidate losses in one pass.
//
// Replaces src/repro/kernels/alpha_search.py::alpha_search_pallas (TPU
// Pallas).  For K step sizes alpha_k it computes
//   losses[k] = sum_i c_i * l(y_i, (xb_i + offset_i) + alpha_k * xdb_i)
// reading every example once for all K candidates.
//
// Bound on the card: operations.  Each example is 16 or 20 bytes, and costs
// K losses of one or two transcendentals each (accurate expf and log1pf,
// or erfcf and logf: tens of fp32-pipe instructions a loss), so at the
// main path's K of 14, 20 and 294 the loss work takes far longer than the
// bytes.  The probe tools/loss_floor.cu times one candidate's work alone
// on the whole card; n K times that is the bound.  So the design keeps the
// pipes busy with losses, reads the data once for all candidates, and
// keeps the rest (reductions, the finish, launches) small beside them.
//
// Design: one CUDA launch of one kernel, alpha_search_pass.
//  * Grid: one wave, the blocks an SM holds (the occupancy API) times the
//    SM count, at most one block per kMinRows rows: block b takes the fixed
//    rows [n b / nb, n (b + 1) / nb), so its partial sums are the same on
//    every run of a card.
//  * K <= 32 (the Gauss-Seidel line search: its grid of 14, its chains of
//    20): examples across threads, candidates in registers.  Thread t of a
//    block takes the block's rows t, t + 256, ... one at a time, with
//    scalar loads, and adds each row's losses for the candidates in groups
//    of 4 with no branch inside a group (a group's losses are independent
//    chains for the compiler to interleave; a branch a candidate left each
//    loss's chain of dependent instructions to run alone).  A row a thread
//    keeps the most warps an SM to hide the losses' latency: float4 quads
//    a thread were up to 1.19 times slower on an H100 (tools/kernel_forms.py
//    keeps those forms).  Templated on the K bucket (16 or 32), so the
//    groups, the sums and the block's reduction (a shuffle tree a warp,
//    then the warps in order) touch live candidates and their group only.
//  * K > 32 (every candidate of the fused Jacobi superstep at once, 294):
//    candidates across lanes, as K6's loss pass (csrc/margin_ls.cu): lane
//    l owns candidates l + 32 j, j < 10, all ten evaluated with no branch
//    (LaneSums).  Warp w of a block takes the
//    contiguous rows [r0 + nr w / 16, r0 + nr (w + 1) / 16) of the block's
//    nr rows; each lane loads one row's (y, b, c, xdb) in a coalesced load
//    of 32 rows, and the rows are given to all lanes by shuffle, so the
//    data are read once for all candidates.  Past 320 candidates, further
//    passes over the block's rows in the same order.  One block an SM:
//    the finish reads K partials a block.
//  * Sums: a thread (K <= 32) or lane (K > 32) adds kInner rows' losses
//    apart, then that into its running total (no drift over a thread's
//    rows); the block adds its warps' totals in warp order, one partial a
//    block and candidate (candidate-major, partials[k nb + b]).
//  * Finish, in the same launch: each block, its partials stored, makes
//    them visible (__threadfence) and takes a ticket (atomicAdd on an
//    unsigned counter the wrapper keeps on the device); the block that
//    draws the last ticket adds every candidate's partials, a warp a
//    candidate (four candidates a warp at a time, each lane's loads of a
//    round issued before its first add): lane l the blocks l, l + 32, ...
//    in order, then a shuffle tree; then it sets the counter back to 0.
//    No floating-point atomics: the same bits on every run.
//  * The margin at candidate k is rounded as the plain version rounds it:
//    the product alpha_k xdb_i, then its sum with b_i (xb_i + offset_i),
//    then loss times c_i.  glm_family.cuh's accurate formulas, no
//    fast-math intrinsics: the losses decide alpha.
#include <cuda_runtime.h>

#include "glm_family.cuh"
#include "resources.cuh"

namespace {

constexpr int kRowsThreads = 256;      // block of the K <= 32 layout
constexpr int kLanesThreads = 512;     // block of the K > 32 layout
constexpr int kMaxRowsK = 32;          // K of the K <= 32 layout, at most
constexpr int kMinRows = 256;          // least rows a block
constexpr int kFinishBatch = 4;        // candidates a warp sums at once
constexpr int kFinishLoads = 16;       // partials a lane loads at once
constexpr int kCandGroup = 4;          // candidates with no branch between
constexpr int kInner = 16;             // rows a thread or lane sums apart
constexpr int kPerLane = 10;           // candidates a lane holds (K > 32)
constexpr int kGroup = 32 * kPerLane;  // candidates a pass (K > 32)

// block b's rows [r0, r1) of n
__device__ __forceinline__ void block_rows(long long n, long long& r0,
                                           long long& r1) {
  r0 = n * blockIdx.x / gridDim.x;
  r1 = n * (blockIdx.x + 1) / gridDim.x;
}

// The grid's last block to finish adds every candidate's partials: a warp
// a candidate, lane l the blocks l, l + 32, ... in order, then a shuffle
// tree; then it sets the ticket counter back to 0 for the next launch.
template <int NT>
__device__ __forceinline__ void finish_if_last(const float* partials, int K,
                                               unsigned int* ticket,
                                               float* out) {
  constexpr int kWarpsNT = NT / 32;
  __shared__ unsigned int is_last;
  __threadfence();          // this thread's partials, visible to the grid
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1u : 0u;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  for (int k0 = warp; k0 < K; k0 += kWarpsNT * kFinishBatch) {
    float t[kFinishBatch];
#pragma unroll
    for (int c = 0; c < kFinishBatch; ++c) t[c] = 0.f;
    // every load of a round is issued before the first add (0 past nb:
    // adding +0 leaves a sum that starts at +0 as it is)
    for (int b0 = lane; b0 < nb; b0 += 32 * kFinishLoads) {
      float v[kFinishBatch][kFinishLoads];
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) {
        const int b = b0 + 32 * u;
#pragma unroll
        for (int c = 0; c < kFinishBatch; ++c) {
          const int k = k0 + c * kWarpsNT;
          v[c][u] = b < nb && k < K
                        ? __ldcg(partials + (long long)k * nb + b)
                        : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u)
#pragma unroll
        for (int c = 0; c < kFinishBatch; ++c) t[c] += v[c][u];
    }
#pragma unroll
    for (int c = 0; c < kFinishBatch; ++c) {
      float v = t[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      const int k = k0 + c * kWarpsNT;
      if (lane == 0 && k < K) out[k] = v;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// K <= KB <= 32: one thread's running sums, candidates in groups of
// kCandGroup with no branch inside a group.  A group's dead candidates
// (k >= K) take alpha = 0 and are never stored.
template <int F, int KB>
struct RowSums {
  static_assert(KB % kCandGroup == 0, "whole groups");
  float a[KB], part[KB], tot[KB];
  int K, inner;

  __device__ void init(const float* alphas, int K_) {
    K = K_;
    inner = 0;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      a[k] = k < K ? alphas[k] : 0.f;
      part[k] = tot[k] = 0.f;
    }
  }

  __device__ void flush() {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      tot[k] += part[k];
      part[k] = 0.f;
    }
    inner = 0;
  }

  // one row's losses, then every kInner rows into the running totals
  __device__ void add(float yi, float base, float ci, float d) {
#pragma unroll
    for (int g = 0; g < KB; g += kCandGroup) {
      if (g < K) {
#pragma unroll
        for (int c = 0; c < kCandGroup; ++c) {
          const float m = __fadd_rn(base, __fmul_rn(a[g + c], d));
          part[g + c] += __fmul_rn(repro::Stats<F>::loss(yi, m), ci);
        }
      }
    }
    if (++inner == kInner) flush();
  }
};

// K > 32: the losses of the candidates k0 .. k0 + kc - 1 across lanes, lane
// l the candidates k0 + l + 32 j, j < kPerLane (K6's loss pass, whose sums
// these are), but every slot evaluated with no branch between them: the
// dead ones (past kc) at alpha = 0, never stored, so a lane's ten losses
// are independent chains the compiler can interleave.  A branch a slot took
// 1.22 times as long on an H100 (tools/kernel_forms.py, form group1).  K6
// keeps its branch: its losses run beside its stream of X, where the dead
// slots' work shows and the divergence does not (1.025 times as long
// branch-free, its form every_slot).
template <int F>
struct LaneSums {
  float a[kPerLane], part[kPerLane], tot[kPerLane];
  int kc, inner;

  __device__ void init(const float* alphas, int k0, int K, int lane) {
    kc = min(kGroup, K - k0);
    inner = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int k = lane + 32 * j;
      a[j] = k < kc ? alphas[k0 + k] : 0.f;
      part[j] = tot[j] = 0.f;
    }
  }

  __device__ void flush() {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      tot[j] += part[j];
      part[j] = 0.f;
    }
    inner = 0;
  }

  __device__ void add(float yi, float base, float ci, float d) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float m = __fadd_rn(base, __fmul_rn(a[j], d));
      part[j] += __fmul_rn(repro::Stats<F>::loss(yi, m), ci);
    }
    if (++inner == kInner) flush();
  }

  // the lane's totals into row ``warp`` of the block's table
  __device__ void store(float (*red)[kGroup], int warp, int lane) {
    flush();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j < kc) red[warp][lane + 32 * j] = tot[j];
  }
};

// KB = 16 or 32: examples across threads, K <= KB candidates in registers;
// KB = 0: candidates across lanes, any K.  One partial a block and
// candidate into partials[k nb + b], then the last block's finish.
template <int F, int KB>
__global__ void __launch_bounds__(KB > 0 ? kRowsThreads : kLanesThreads)
    alpha_search_pass(const float* __restrict__ y,
                      const float* __restrict__ xb,
                      const float* __restrict__ xdb,
                      const float* __restrict__ weights,
                      const float* __restrict__ offset,
                      const float* __restrict__ alphas, int K, long long n,
                      float* __restrict__ partials,
                      unsigned int* __restrict__ ticket,
                      float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = gridDim.x;
  long long r0, r1;
  block_rows(n, r0, r1);

  if constexpr (KB > 0) {
    constexpr int kWarpsA = kRowsThreads / 32;
    __shared__ float red[kWarpsA][KB];
    RowSums<F, KB> rs;
    rs.init(alphas, K);
    // the block's rows: thread t takes t, t + 256, ...
    for (long long i = r0 + tid; i < r1; i += kRowsThreads) {
      float base = xb[i];
      if (offset != nullptr) base = base + offset[i];
      rs.add(y[i], base, weights[i], xdb[i]);
    }
    rs.flush();
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        float v = rs.tot[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][k] = v;
      }
    }
    __syncthreads();
    if (tid < K) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsA; ++w) s += red[w][tid];
      partials[(long long)tid * nb + blockIdx.x] = s;
    }
    finish_if_last<kRowsThreads>(partials, K, ticket, out);
  } else {
    constexpr int kWarpsB = kLanesThreads / 32;
    __shared__ float red[kWarpsB][kGroup];
    const long long nr = r1 - r0;
    const long long w0 = r0 + nr * warp / kWarpsB;
    const long long w1 = r0 + nr * (warp + 1) / kWarpsB;
    for (int k0 = 0; k0 < K; k0 += kGroup) {
      LaneSums<F> ls;
      ls.init(alphas, k0, K, lane);
      for (long long g = w0; g < w1; g += 32) {
        // (y, b, c, xdb) of the next 32 rows, a lane each
        float yl = 0.f, bl = 0.f, cl = 0.f, dl = 0.f;
        if (g + lane < w1) {
          const long long i = g + lane;
          yl = y[i];
          cl = weights[i];
          bl = xb[i];
          if (offset != nullptr) bl = bl + offset[i];
          dl = xdb[i];
        }
        const int ng = (int)min(32LL, w1 - g);
        for (int r = 0; r < ng; ++r)
          ls.add(__shfl_sync(0xffffffffu, yl, r),
                 __shfl_sync(0xffffffffu, bl, r),
                 __shfl_sync(0xffffffffu, cl, r),
                 __shfl_sync(0xffffffffu, dl, r));
      }
      ls.store(red, warp, lane);
      __syncthreads();
      const int kc = min(kGroup, K - k0);
      if (tid < kc) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpsB; ++w) s += red[w][tid];
        partials[(long long)(k0 + tid) * nb + blockIdx.x] = s;
      }
      __syncthreads();      // the table is read before the next pass
    }
    finish_if_last<kLanesThreads>(partials, K, ticket, out);
  }
}

#define ALPHA_PASS(F, KB) \
  {(const void*)alpha_search_pass<F, KB>, "alpha_search_pass<" #F "," #KB ">"}
#define ALPHA_FAMILY(F) ALPHA_PASS(F, 16), ALPHA_PASS(F, 32), ALPHA_PASS(F, 0)

const repro::KernelSlot kSlots[] = {ALPHA_FAMILY(0), ALPHA_FAMILY(1),
                                    ALPHA_FAMILY(2), ALPHA_FAMILY(3)};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

// the kernel of one family and K bucket: its block size, its blocks an SM
// at most (lanes layout: one) and its slot in the table of waves
struct Pass {
  const void* fn;
  int threads;
  int max_per_sm;
  int slot;
};

constexpr int kBuckets = 3;            // K <= 16, K <= 32, K > 32
constexpr int kMaxDevices = 64;

template <int F>
Pass pass_of(int K) {
  if (K <= 16)
    return {(const void*)alpha_search_pass<F, 16>, kRowsThreads, 1 << 30,
            F * kBuckets};
  if (K <= kMaxRowsK)
    return {(const void*)alpha_search_pass<F, 32>, kRowsThreads, 1 << 30,
            F * kBuckets + 1};
  return {(const void*)alpha_search_pass<F, 0>, kLanesThreads, 1,
          F * kBuckets + 2};
}

cudaError_t pass_for(int family, int K, Pass& p) {
  switch (family) {
    case repro::kLogistic: p = pass_of<repro::kLogistic>(K); break;
    case repro::kSquared: p = pass_of<repro::kSquared>(K); break;
    case repro::kProbit: p = pass_of<repro::kProbit>(K); break;
    case repro::kPoisson: p = pass_of<repro::kPoisson>(K); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// blocks of one wave of the pass on the current device: the occupancy API
// times the SM count, looked up at the first launch of each device and
// kernel (a value a slot: concurrent first launches write the same one)
cudaError_t wave_of(const Pass& p, long long& wave) {
  static long long waves[kMaxDevices][4 * kBuckets];    // 0: not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long& w = waves[dev][p.slot];
  if (w == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, p.fn, p.threads, 0)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    w = (long long)sms * min(per_sm, p.max_per_sm);
  }
  wave = w;
  return cudaSuccess;
}

// blocks of the launch for n rows: one wave, at most one block per
// kMinRows rows
cudaError_t grid_of(const Pass& p, long long n, int& nblocks) {
  long long wave = 0;
  cudaError_t err = wave_of(p, wave);
  if (err != cudaSuccess) return err;
  nblocks = (int)max(1LL, min(wave, (n + kMinRows - 1) / kMinRows));
  return cudaSuccess;
}

}  // namespace

// y, xb, xdb, weights, offset (may be null): (n,); alphas, out: (K,).
// Scratch from the caller: partials of partials_len floats (K times the
// blocks of repro_alpha_search_grid at most), and an unsigned counter at 0
// that the launch leaves at 0 (launches sharing it run one after another,
// on one stream).
extern "C" int repro_alpha_search(const float* y, const float* xb,
                                  const float* xdb, const float* weights,
                                  const float* offset, const float* alphas,
                                  int K, long long n, float* partials,
                                  long long partials_len,
                                  unsigned int* ticket, float* out,
                                  int family, void* stream) {
  if (K <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  Pass p;
  cudaError_t err = pass_for(family, K, p);
  if (err != cudaSuccess) return (int)err;
  int nblocks = 0;
  if ((err = grid_of(p, n, nblocks)) != cudaSuccess) return (int)err;
  if ((long long)nblocks * K > partials_len)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&y, &xb, &xdb,      &weights, &offset, &alphas,
                  &K, &n,  &partials, &ticket,  &out};
  err = repro::note_launch(kSlots, kMax, p.fn, 0, p.threads);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(p.fn, dim3(nblocks), dim3(p.threads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The blocks (and, in *threads, the block size) of the launch
// repro_alpha_search makes for n rows and K candidates of the family on
// the current device, or -1 on a CUDA error.
extern "C" int repro_alpha_search_grid(long long n, int K, int family,
                                       int* threads) {
  Pass p;
  int nblocks = 0;
  if (K <= 0 || n < 0 || pass_for(family, K, p) != cudaSuccess ||
      grid_of(p, n, nblocks) != cudaSuccess)
    return -1;
  if (threads != nullptr) *threads = p.threads;
  return nblocks;
}

REPRO_RESOURCES_ENTRY(alpha_search)
