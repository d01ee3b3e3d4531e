// K3 tile_gram: Gram block and gradient of one feature tile of the
// CSR-of-bricks layout.
//
// Replaces src/repro/kernels/tile_gram.py::tile_gram_pallas (TPU Pallas).
// Over the live bricks k < n_valid of one tile (each a row_block x T dense
// slab b_k whose rows are row block rows[k] of the examples):
//   G = sum_k b_k^T diag(w[rows_k]) b_k   (T x T),  g = sum_k b_k^T r[rows_k]
//
// Bounds on the card: operations.  G is symmetric, so the least work is its
// T (T + 1) / 2 unique entries, n_valid * rb * T * (T + 1) flops, against
// n_valid * rb * T * 4 bytes of bricks (about T / 4 = 64 flops a byte at
// T = 256).  On the fp32 FMA pipes that is flops / 67 TFLOP/s; on the
// tensor cores this kernel uses, three TF32 products of it over 495 TFLOP/s.
//
// Design: the TPU kernel walked the bricks on a sequential grid and carried
// G in VMEM between steps; blocks on the card run in parallel and carry
// nothing.  So the work is cut two ways: the upper-triangle BN x BN blocks
// of G (3 of 4 at T = 256, BN = 128; all 4 in the bf16 mode) and `splits`
// contiguous ranges of
// the bricks' 32-row slabs, enough blocks to fill every SM.  Each block
// streams its bricks' rows in place from the tile's slice of the brick
// array (a TMA map over it, no gather copy), w and r gathered through
// rows[k], into the shared 3xTF32 tensor-core core of gram_tc.cuh (why
// 3xTF32, and the staging, are explained there).  Slots k >= n_valid are
// never read.  Each block writes its partial to scratch; a
// second pass adds the partials in split order and mirrors the upper blocks
// (entry (i, j), i > j, is read from (j, i)), so G is exactly symmetric.
// No atomics, so G and g are the same from run to run.
//
// The bf16 mode (precision="bf16" of the fused Jacobi superstep on bricks;
// the reference forms it in ref.py::gram_brick_tiles) rounds the product
// inputs to bf16 as gram_tc.cuh's kBF16 describes: the brick times its
// gathered weight is formed in fp32 and then rounded (the weight itself is
// not), and so are the brick and r for g.  Its G is not symmetric: every
// block pair is computed, and the reduce mirrors none.  Its bound is bytes
// (one bf16 product a k step in place of three TF32 ones, at 989 TFLOP/s).
#include <cuda_runtime.h>

#include "gram_tc.cuh"
#include "resources.cuh"

namespace {

using repro::gram::kSlab;

constexpr int kMaxBricks = 256;   // bricks a block may touch (see launch)

// the rows of the live bricks as one stream of 32-row slabs (spb a brick;
// rows of the last slab past rb get w = r = 0), from slab s0 on; the
// row-block ids of the block's bricks, from brick k_first on, are in
// shared memory
struct BrickRows {
  struct In {
    float w, r;
  };
  const int* rows_s;
  const float* w;
  const float* r;
  int rb, s0, spb, k_first;

  // bricks are rows of the (slots * rb, T) map, slab by slab
  __device__ int slab_row(int s) const {
    return ((s0 + s) / spb) * rb + ((s0 + s) % spb) * kSlab;
  }
  __device__ In fetch(int s, int i) const {
    const int rr = ((s0 + s) % spb) * kSlab + i;
    if (rr >= rb) return In{0.f, 0.f};
    const long long at =
        (long long)rows_s[(s0 + s) / spb - k_first] * rb + rr;
    return In{__ldg(w + at), __ldg(r + at)};
  }
  __device__ void stats(const In& in, int, int, float& wv, float& rv) const {
    wv = in.w;
    rv = in.r;
  }
};

template <int BN, int P>
__global__ void __launch_bounds__(repro::gram::threads<BN>(), 1)
    tile_gram_partial(const __grid_constant__ CUtensorMap bricks,
                      const int* __restrict__ rows, int n_valid, int per,
                      const float* __restrict__ w,
                      const float* __restrict__ r, int rb, int T,
                      float* __restrict__ Gp, float* __restrict__ gp) {
  __shared__ int rows_s[kMaxBricks];
  const int nb = T / BN;
  const int npairs = repro::gram::n_pairs<P>(nb);
  int bi, bj;
  repro::gram::pair_coords<P>(blockIdx.x, nb, bi, bj);
  const int split = blockIdx.y;
  const int spb = (rb + kSlab - 1) / kSlab;
  const int s0 = split * per;
  const int s1 = min(s0 + per, n_valid * spb);
  const int k_first = s0 / spb;
  for (int k = k_first + (int)threadIdx.x; s1 > s0 && k <= (s1 - 1) / spb;
       k += blockDim.x)
    rows_s[k - k_first] = rows[k];
  __syncthreads();
  const BrickRows src{rows_s, w, r, rb, s0, spb, k_first};
  repro::gram::band<BN, P>(
      src, &bricks, 0, max(s1 - s0, 0), bi * BN, bj * BN, bi == bj,
      Gp + ((long long)split * npairs + blockIdx.x) * BN * BN,
      gp + (long long)split * T + bi * BN);
}

// full: every block pair was computed (the bf16 mode), none is mirrored
__global__ void tile_gram_reduce(const float* __restrict__ Gp,
                                 const float* __restrict__ gp, int splits,
                                 int T, int BN, bool full,
                                 float* __restrict__ G,
                                 float* __restrict__ g) {
  const int nb = T / BN;
  const long long block = (long long)BN * BN;
  const long long slot = block * (full ? nb * nb : nb * (nb + 1) / 2);
  const long long TT = (long long)T * T;
  const long long total = TT + T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    float tot = 0.f;
    if (idx < TT) {
      const long long off = repro::gram::entry_offset(
          (int)(idx / T), (int)(idx % T), nb, BN, full);
      for (int s = 0; s < splits; ++s) tot += Gp[s * slot + off];
      G[idx] = tot;
    } else {
      const long long j = idx - TT;
      for (int s = 0; s < splits; ++s) tot += gp[s * T + j];
      g[j] = tot;
    }
  }
}

#define TILE_GRAM_PARTIAL(BN, P) \
  {(const void*)tile_gram_partial<BN, P>, "tile_gram_partial<" #BN "," #P ">"}

const repro::KernelSlot kSlots[] = {
    TILE_GRAM_PARTIAL(64, 0), TILE_GRAM_PARTIAL(64, 1),
    TILE_GRAM_PARTIAL(128, 0), TILE_GRAM_PARTIAL(128, 1),
    {(const void*)tile_gram_reduce, "tile_gram_reduce"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

template <int BN, int P>
cudaError_t launch_partial(int splits, cudaStream_t st, const float* bricks,
                           int slots, const int* rows, int n_valid, int per,
                           const float* w, const float* r, int rb, int T,
                           float* Gp, float* gp) {
  constexpr size_t smem = repro::gram::smem_bytes<BN, P>();
  cudaError_t err = repro::gram::allow_smem(tile_gram_partial<BN, P>, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = repro::gram::make_map(&map, bricks, (long long)slots * rb, T, T);
  if (err != cudaSuccess) return err;
  const dim3 grid(repro::gram::n_pairs<P>(T / BN), splits);
  err = repro::note_launch(kSlots, kMax, (const void*)tile_gram_partial<BN, P>,
                           smem, repro::gram::threads<BN>());
  if (err != cudaSuccess) return err;
  tile_gram_partial<BN, P><<<grid, repro::gram::threads<BN>(), smem, st>>>(
      map, rows, n_valid, per, w, r, rb, T, Gp, gp);
  return cudaGetLastError();
}

}  // namespace

// bricks: the tile's bricks, (slots >= n_valid, rb, T) contiguous and
// 16-byte aligned; rows: their
// row-block ids; w, r: (n_rows,) vectors.  band: the block edge BN (128, or
// 64; T a multiple of it); bf16: 1 for the bf16 mode, 0 for 3xTF32.
// Scratch Gp (splits, npairs, BN, BN) and gp (splits, T) come from the
// caller, npairs = nb (nb + 1) / 2, or nb^2 in the bf16 mode, with nb =
// T / BN.  The live bricks' rows are one stream of 32-row slabs
// (ceil(rb / 32) a brick); slabs [s*per, (s+1)*per) go to split s.
extern "C" int repro_tile_gram(const float* bricks, int slots,
                               const int* rows, int n_valid, int splits,
                               int per,
                               const float* w, const float* r, int rb, int T,
                               int band, int bf16, float* Gp, float* gp,
                               float* G, float* g, void* stream) {
  // a block's slabs span at most per / spb + 2 bricks
  if (T <= 0 || (band != 64 && band != 128) || T % band != 0 ||
      splits <= 0 || rb <= 0 || n_valid < 0 || n_valid > slots ||
      per < 0 ||
      per / ((rb + kSlab - 1) / kSlab) + 2 > kMaxBricks ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using repro::gram::kBF16;
  using repro::gram::kTF32;
  auto* fn = band == 128 ? (bf16 ? &launch_partial<128, kBF16>
                                 : &launch_partial<128, kTF32>)
                         : (bf16 ? &launch_partial<64, kBF16>
                                 : &launch_partial<64, kTF32>);
  cudaError_t err =
      fn(splits, st, bricks, slots, rows, n_valid, per, w, r, rb, T, Gp, gp);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)T * T + T;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  err = repro::note_launch(kSlots, kMax, (const void*)tile_gram_reduce, 0,
                           256);
  if (err != cudaSuccess) return (int)err;
  tile_gram_reduce<<<(int)blocks, 256, 0, st>>>(Gp, gp, splits, T, band,
                                                bf16 != 0, G, g);
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(tile_gram)
