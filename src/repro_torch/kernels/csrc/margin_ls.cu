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
// 0.98 ms at 3.35 TB/s); the product is 2 flops per element and the
// candidates one or two transcendentals per row each, far below that.  So
// the design keeps enough bytes in flight on every SM for the whole pass,
// and keeps the loss work off the stream.
//
// Design: a streamed pass over fixed row ranges.
//  * Grid: one block an SM at a time (the occupancy API; the rings take
//    most of shared memory), up to kWaves blocks an SM in all, at most one
//    block per 1,024 rows: 391 blocks, about three waves, at n = 400,000.
//    Block b takes the fixed rows [n b / nb, n (b + 1) / nb), one
//    contiguous range of X, so the partial sums are the same on every run
//    of a card.  No work queue.  (One wave of 132 blocks was 1.5% slower on
//    the card: a static split leaves the kernel to its slowest SM, and
//    several waves let the block scheduler even them out.)
//  * Stream: each of a block's sixteen warps streams its own share of the
//    block's rows, item i to warp i mod 16.  An item is as many whole rows
//    as fit in kStage floats, or a wider row in kStage-column chunks (two at
//    p = 2,048), one 1-D bulk copy (cp.async.bulk into shared memory,
//    completion on an mbarrier) each.  Lane 0 keeps the warp's ring of
//    kDepth copies in flight: it refills a stage as soon as the warp has
//    read it, so 32-48 copies (128-192 KB) an SM are on their way.  (One
//    producer warp feeding one shared ring is not as simple: with chunked
//    rows, consecutive stages belong to different warps, and a warp could
//    poll a stage's barrier two phases early and pass.  A ring a warp has
//    one reader and one writer, so its phases come in order.)
//  * Losses: a warp forms each row's dot product from shared memory (lane l
//    the columns 4 l + 128 q in four partial sums, then a butterfly of
//    shuffles, so every lane holds xdb_i), writes xdb_i and adds the row's
//    losses with the candidates across lanes: lane l owns candidates
//    l + 32 j, j < 10, alphas and sums in registers, and (y, b, c) of 32
//    rows are loaded a lane each before the copy is awaited and broadcast
//    by shuffle.  The loss work runs while the warp's next copies land.
//    Candidates past 320 take further passes over the block's rows in the
//    same order, from the xdb the block wrote.
//  * Sums: a lane adds 16 rows' losses, then that into its running total (a
//    warp's hundreds of rows in one float32 chain would drift by up to rows
//    x 6e-8); the block adds its warps' totals in warp order, one partial a
//    block and candidate; the finishing pass adds a candidate's partials
//    with one warp, every lane a strided run of blocks, then a shuffle tree.
//    No atomics: the same bits every run.
//  * The margin at candidate k is rounded as the plain version rounds it:
//    the product alpha_k xdb_i, then its sum with b_i, then loss times c_i.
//  * The bf16 mode (precision="bf16", the bf16 branch of the TPU kernel,
//    superstep_tile.py:217-222) rounds each X element to bf16 as the dot
//    product reads it from the stage, and dbeta as it is staged (or, past
//    kDbetaShared columns, where it is read from global memory, as it is
//    read); the products of bf16 values are exact in fp32, the dot
//    product's sums and the losses are fp32, and the stream is unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_family.cuh"
#include "mbarrier.cuh"
#include "resources.cuh"

namespace {

constexpr int kWarps = 16;                // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 1024;       // the least rows a block
constexpr int kWaves = 4;                 // blocks an SM slot, at most
constexpr int kStage = 1024;              // floats a copy (4 KB)
constexpr int kDepth = 3;                 // copies in a warp's ring
constexpr int kDbetaShared = 8192;        // dbeta staged up to this p
constexpr int kFinishWarps = 8;           // of the finishing pass
constexpr int kPerLane = 10;              // candidates a lane holds
constexpr int kGroup = 32 * kPerLane;     // candidates a pass
constexpr int kInner = 16;                // rows a lane sums apart
static_assert(kGroup <= kDepth * kStage, "the totals must fit the rings");

// the losses of one group of candidates (k0 .. k0 + kc - 1), across lanes
template <int F>
struct LossSums {
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

  __device__ void add(int lane, float yi, float base, float ci, float d) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (lane + 32 * j < kc) {
        const float m = __fadd_rn(base, __fmul_rn(a[j], d));
        part[j] += __fmul_rn(repro::Stats<F>::loss(yi, m), ci);
      }
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

// fp32 -> bf16 -> fp32, to nearest even, of each element
__device__ __forceinline__ float4 to_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

// lane's four partial sums of row . dbeta over columns 4 lane + 128 q < cw;
// RX, RD: round the row's and dbeta's elements to bf16 first
template <bool RX, bool RD>
__device__ __forceinline__ void dot_part(const float* row, const float* dv,
                                         int cw, int lane, float4& s) {
  for (int c = lane * 4; c < cw; c += 128) {
    float4 x = *reinterpret_cast<const float4*>(row + c);
    float4 d = *reinterpret_cast<const float4*>(dv + c);
    if (RX) x = to_bf16(x);
    if (RD) d = to_bf16(d);
    s.x = fmaf(x.x, d.x, s.x);
    s.y = fmaf(x.y, d.y, s.y);
    s.z = fmaf(x.z, d.z, s.z);
    s.w = fmaf(x.w, d.w, s.w);
  }
}

// the row's dot product in every lane
__device__ __forceinline__ float dot_finish(const float4& s) {
  float v = (s.x + s.y) + (s.z + s.w);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's rows of one group of candidates: warps' totals in warp order
__device__ __forceinline__ void store_partials(float (*red)[kGroup], int kc,
                                               float* out) {
  for (int k = threadIdx.x; k < kc; k += kThreads) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w][k];
    out[k] = tot;
  }
}

template <int F, bool B16>
__global__ void __launch_bounds__(kThreads, 1)
    margin_ls_stream(const float* __restrict__ X, long long n, int p,
                     const float* __restrict__ dbeta,
                     const float* __restrict__ y,
                     const float* __restrict__ xb,
                     const float* __restrict__ weights,
                     const float* __restrict__ offset,
                     const float* __restrict__ alphas, int K,
                     float* __restrict__ xdb, float* __restrict__ partials) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[kWarps][kDepth];
  // the warps' totals, in the rings once the stream is done
  float(*red)[kGroup] = reinterpret_cast<float(*)[kGroup]>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ring = smem + warp * kDepth * kStage;     // this warp's stages
  float* d_s = smem + kWarps * kDepth * kStage;
  uint64_t* bar = full[warp];
  const long long r0 = n * blockIdx.x / gridDim.x;
  const int nrows = (int)(n * (blockIdx.x + 1) / gridDim.x - r0);
  // an item: rows_per whole rows, or a row in ``chunks`` copies
  const int rows_per = p <= kStage ? kStage / p : 1;
  const int chunks = (p + kStage - 1) / kStage;
  const int items = (nrows + rows_per - 1) / rows_per;
  // this warp's copies: item warp + kWarps (j / chunks), chunk j % chunks
  const int copies = (items > warp ? (items - warp + kWarps - 1) / kWarps
                                   : 0) * chunks;
  auto issue = [&](int j) {
    const int it = warp + kWarps * (j / chunks), ch = j % chunks;
    const int nf = chunks > 1 ? min(kStage, p - ch * kStage)
                              : min(rows_per, nrows - it * rows_per) * p;
    uint64_t* b = &bar[j % kDepth];
    repro::mbar_expect(b, nf * 4u);
    repro::bulk_load(ring + (j % kDepth) * kStage,
                     X + (r0 + (long long)it * rows_per) * p + ch * kStage,
                     nf * 4u, b);
  };

  if (tid == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int s = 0; s < kDepth; ++s) repro::mbar_init(&full[w][s], 1);
    repro::mbar_init_fence();
  }
  const bool d_shared = p <= kDbetaShared;
  if (d_shared)
    for (int c = tid; c < p; c += kThreads)
      d_s[c] = B16 ? __bfloat162float(__float2bfloat16_rn(dbeta[c]))
                   : dbeta[c];
  const float* dv = d_shared ? d_s : dbeta;
  __syncthreads();
  if (lane == 0)
    for (int j = 0; j < min(kDepth, copies); ++j) issue(j);

  LossSums<F> ls;
  ls.init(alphas, 0, K, lane);
  for (int it = warp, j0 = 0; it < items; it += kWarps, j0 += chunks) {
    const int i0 = it * rows_per;
    const int nr = min(rows_per, nrows - i0);
    for (int g0 = 0; g0 < nr; g0 += 32) {
      // (y, b, c) of the next 32 rows, a lane each, issued before the copy
      // is awaited
      float yl = 0.f, bl = 0.f, cl = 0.f;
      if (g0 + lane < nr) {
        const long long i = r0 + i0 + g0 + lane;
        yl = y[i];
        cl = weights[i];
        bl = xb[i];
        if (offset != nullptr) bl = bl + offset[i];
      }
      const int ng = min(32, nr - g0);
      for (int r = 0; r < ng; ++r) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int ch = 0; ch < chunks; ++ch) {
          const int j = j0 + ch;
          const float* st = ring + (j % kDepth) * kStage;
          if (chunks > 1 || (g0 == 0 && r == 0))
            repro::mbar_wait(&bar[j % kDepth], (j / kDepth) & 1);
          const int c0 = ch * kStage;
          const float* row = st + (chunks > 1 ? 0 : (g0 + r) * p);
          const int cw = min(kStage, p - c0);
          if (!B16 || d_shared)   // dbeta staged as it is to be read
            dot_part<B16, false>(row, dv + c0, cw, lane, s);
          else
            dot_part<true, true>(row, dv + c0, cw, lane, s);
          // the stage is read: refill it while the losses are summed
          if (chunks > 1 || g0 + r == nr - 1) {
            __syncwarp();
            if (lane == 0 && j + kDepth < copies) issue(j + kDepth);
          }
        }
        const float d = dot_finish(s);
        if (lane == 0) xdb[r0 + i0 + g0 + r] = d;
        ls.add(lane, __shfl_sync(0xffffffffu, yl, r),
               __shfl_sync(0xffffffffu, bl, r),
               __shfl_sync(0xffffffffu, cl, r), d);
      }
    }
  }
  __syncthreads();   // every ring drained: the totals may take their place
  ls.store(red, warp, lane);
  __syncthreads();
  store_partials(red, min(kGroup, K), partials + (long long)blockIdx.x * K);

  // candidates past the first group: more passes over the block's rows in
  // the same order, from the xdb the block wrote
  for (int k0 = kGroup; k0 < K; k0 += kGroup) {
    __syncthreads();
    {
      LossSums<F> ls;
      ls.init(alphas, k0, K, lane);
      for (int it = warp; it < items; it += kWarps) {
        const int i0 = it * rows_per;
        const int nr = min(rows_per, nrows - i0);
        for (int r = 0; r < nr; ++r) {
          const long long i = r0 + i0 + r;
          float base = xb[i];
          if (offset != nullptr) base = base + offset[i];
          ls.add(lane, y[i], base, weights[i], xdb[i]);
        }
      }
      ls.store(red, warp, lane);
    }
    __syncthreads();
    store_partials(red, min(kGroup, K - k0),
                   partials + (long long)blockIdx.x * K + k0);
  }
}

// one warp per candidate: blockDim.x = 32 * kFinishWarps, candidate k =
// the block's warp index
__global__ void margin_ls_finish(const float* __restrict__ partials,
                                 int nblocks, int K,
                                 float* __restrict__ losses) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  if (k >= K) return;
  float tot = 0.f;
  for (int b = lane; b < nblocks; b += 32)
    tot += partials[(long long)b * K + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  if (lane == 0) losses[k] = tot;
}

template <int F, bool B16>
cudaError_t grid_of(long long n, int p, int& nblocks, size_t& smem) {
  smem = sizeof(float) *
         (kWarps * kDepth * kStage + (p <= kDbetaShared ? p : 0));
  cudaError_t err = cudaFuncSetAttribute(
      margin_ls_stream<F, B16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, margin_ls_stream<F, B16>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  nblocks = (int)min(cap, (long long)sms * per_sm * kWaves);
  return cudaSuccess;
}

#define MARGIN_LS_STREAM(F, B16) \
  {(const void*)margin_ls_stream<F, B16>, "margin_ls_stream<" #F "," #B16 ">"}
#define MARGIN_LS_FAMILY(F) \
  MARGIN_LS_STREAM(F, false), MARGIN_LS_STREAM(F, true)

const repro::KernelSlot kSlots[] = {
    MARGIN_LS_FAMILY(0), MARGIN_LS_FAMILY(1), MARGIN_LS_FAMILY(2),
    MARGIN_LS_FAMILY(3),
    {(const void*)margin_ls_finish, "margin_ls_finish"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

template <int F, bool B16>
cudaError_t launch_mode(const float* X, long long n, int p,
                        const float* dbeta, const float* y, const float* xb,
                        const float* weights, const float* offset,
                        const float* alphas, int K, float* xdb,
                        float* partials, float* losses, cudaStream_t st) {
  int nblocks = 0;
  size_t smem = 0;
  cudaError_t err = grid_of<F, B16>(n, p, nblocks, smem);
  if (err != cudaSuccess) return err;
  err = repro::note_launch(kSlots, kMax, (const void*)margin_ls_stream<F, B16>,
                           smem, kThreads);
  if (err != cudaSuccess) return err;
  margin_ls_stream<F, B16><<<nblocks, kThreads, smem, st>>>(
      X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = repro::note_launch(kSlots, kMax, (const void*)margin_ls_finish, 0,
                           32 * kFinishWarps);
  if (err != cudaSuccess) return err;
  margin_ls_finish<<<(K + kFinishWarps - 1) / kFinishWarps,
                      32 * kFinishWarps, 0, st>>>(partials, nblocks, K,
                                                  losses);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch(bool bf16, const float* X, long long n, int p,
                   const float* dbeta, const float* y, const float* xb,
                   const float* weights, const float* offset,
                   const float* alphas, int K, float* xdb, float* partials,
                   float* losses, cudaStream_t st) {
  auto* fn = bf16 ? &launch_mode<F, true> : &launch_mode<F, false>;
  return fn(X, n, p, dbeta, y, xb, weights, offset, alphas, K, xdb,
            partials, losses, st);
}

}  // namespace

// X: (n, p) row-major, p a multiple of 4 (16-byte rows); dbeta (p,), 16-byte
// aligned; y, xb, weights, offset (may be null), xdb: (n,); alphas, losses:
// (K,).  Scratch partials (ceil(n / 1024) * K) from the caller.  bf16: 1
// for the bf16 mode, 0 for fp32.
extern "C" int repro_margin_ls(const float* X, long long n, int p,
                               const float* dbeta, const float* y,
                               const float* xb, const float* weights,
                               const float* offset, const float* alphas,
                               int K, float* xdb, float* partials,
                               float* losses, int family, int bf16,
                               void* stream) {
  if (n <= 0 || p <= 0 || p % 4 != 0 || K <= 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dbeta) % 16 != 0 ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case repro::kLogistic:
      return (int)launch<repro::kLogistic>(bf16, X, n, p, dbeta, y, xb,
                                           weights, offset, alphas, K, xdb,
                                           partials, losses, st);
    case repro::kSquared:
      return (int)launch<repro::kSquared>(bf16, X, n, p, dbeta, y, xb,
                                          weights, offset, alphas, K, xdb,
                                          partials, losses, st);
    case repro::kProbit:
      return (int)launch<repro::kProbit>(bf16, X, n, p, dbeta, y, xb,
                                         weights, offset, alphas, K, xdb,
                                         partials, losses, st);
    case repro::kPoisson:
      return (int)launch<repro::kPoisson>(bf16, X, n, p, dbeta, y, xb,
                                          weights, offset, alphas, K, xdb,
                                          partials, losses, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The blocks of the pass repro_margin_ls launches for n rows of p columns
// on the current device (one partial sum each a candidate; the same for
// every family: shared memory allows one block an SM), or -1 on a CUDA
// error.
extern "C" int repro_margin_ls_grid(long long n, int p) {
  int nblocks = 0;
  size_t smem = 0;
  if (n <= 0 || p <= 0) return -1;
  return grid_of<repro::kLogistic, false>(n, p, nblocks, smem) ==
                 cudaSuccess
             ? nblocks
             : -1;
}

REPRO_RESOURCES_ENTRY(margin_ls)
