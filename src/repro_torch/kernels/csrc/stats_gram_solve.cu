// K5 stats_gram_solve: fused launch 1 of the Jacobi superstep on a dense
// design -- the link stats, every live tile's Gram block and gradient, and
// each live tile's coordinate chain from a zero step.
//
// Replaces src/repro/kernels/superstep_tile.py::stats_gram_solve_pallas
// (TPU Pallas).  With c_i the observation weight and m_i = xb_i + offset_i:
//   loss_i, s_i, w_i = c_i * (l, -dl/dm, d2l/dm2)(y_i, m_i)
//   G_t = sum_i w_i x_it x_it^T  (T x T),   g_t = sum_i s_i x_it
//   dbeta_t = the cd_chain.cuh chain on (G_t, g_t) from a zero step
// for each live tile t, where x_it is row i's slice [tT, (t+1)T) of the
// row-major (n, p) design.  Dead tiles get G = g = 0 and a zero step.
//
// Bounds on the card: operations.  G_t is symmetric, so the least work is
// its T (T + 1) / 2 unique entries, n T (T + 1) flops a tile against n T 4
// bytes of X (about T / 4 = 64 flops a byte at T = 256).  On the fp32 FMA
// pipes that is flops / 67 TFLOP/s; on the tensor cores this kernel uses,
// three TF32 products of it over 495 TFLOP/s.
//
// Design.  The TPU kernel walked a sequential grid (tile, row block) over a
// tile-major copy of X and carried G in VMEM.  Here X is read in place from
// the row-major array (tile t of row i is 1 KiB contiguous at T = 256), and
// the work is cut three ways so a handful of tiles still fills 132 SMs:
// live tile x upper-triangle BN x BN block of G (3 of 4 at T = 256, BN =
// 128) x range of rows.  Three CUDA launches make one logical launch:
//   1. sgs_partial: each block streams 32-row slabs of its one or two
//      column ranges through the 3xTF32 tensor-core core of gram_tc.cuh
//      (why 3xTF32, the staging and the sums' levels are explained there),
//      forming (loss, s, w) of each slab's rows inline from (y, xb, offset,
//      weights); one block per row range writes them out, so they leave
//      once, not once per tile.  Diagonal blocks also accumulate g.  A row
//      range is at most 4,096 rows, so the accumulators drained every 128
//      rows into a second sum and the ranges' partials summed in the
//      second launch keep three float32 levels over 400,000 rows.
//   2. sgs_reduce: adds the partials of each G and g entry in row-range
//      order (no atomics: the same sums every run), mirrors the upper
//      blocks (entry (i, j), i > j, is read from (j, i), so G is exactly
//      symmetric) and writes dead tiles' G and g as zeros.
//   3. sgs_solve: one block of T threads per tile runs the chain on the
//      tile's G (h = diag G) from a zero step; dead tiles write 0.
// ``order`` is the tile remap of the TPU kernel's scalar prefetch: live
// tiles first, then dead ones; blocks past n_live do no Gram or solve work.
#include <cuda_runtime.h>

#include "cd_chain.cuh"
#include "glm_family.cuh"
#include "gram_tc.cuh"

namespace {

using repro::gram::kSlab;

// rows [r_begin, r_end) of tile c0 of X as 32-row slabs, with the link
// stats formed inline (and written out by the writer block)
template <int F>
struct TileRows {
  struct In {
    float y, xb, c, off;
  };
  long long r_begin, r_end;
  const float* y;
  const float* xb;
  const float* weights;
  const float* offset;
  float* loss;
  float* s_out;
  float* w_out;
  bool writer;

  __device__ int slab_row(int s) const {
    return (int)(r_begin + (long long)s * kSlab);
  }
  __device__ In fetch_row(long long i) const {
    if (i >= r_end) return In{0.f, 0.f, 0.f, 0.f};
    return In{__ldg(y + i), __ldg(xb + i), __ldg(weights + i),
              offset != nullptr ? __ldg(offset + i) : 0.f};
  }
  __device__ In fetch(int s, int r) const {
    return fetch_row(r_begin + (long long)s * kSlab + r);
  }
  __device__ void stats(const In& in, int s, int r, float& wv,
                        float& sv) const {
    stats_row(in, r_begin + (long long)s * kSlab + r, wv, sv);
  }
  __device__ void stats_row(const In& in, long long i, float& wv,
                            float& sv) const {
    wv = sv = 0.f;
    if (i >= r_end) return;
    float m = in.xb;
    if (offset != nullptr) m = m + in.off;
    float l;
    repro::Stats<F>::all(in.y, m, l, sv, wv);
    l = l * in.c;
    sv = sv * in.c;
    wv = wv * in.c;
    if (writer) {
      loss[i] = l;
      s_out[i] = sv;
      w_out[i] = wv;
    }
  }
};

template <int F, int BN>
__global__ void __launch_bounds__(repro::gram::threads<BN>(), 1)
    sgs_partial(const __grid_constant__ CUtensorMap X, long long n, int T,
                const float* __restrict__ y, const float* __restrict__ xb,
                const float* __restrict__ weights,
                const float* __restrict__ offset,
                const int* __restrict__ order, int n_live, int per,
                float* __restrict__ Gp, float* __restrict__ gp,
                float* __restrict__ loss, float* __restrict__ s_out,
                float* __restrict__ w_out) {
  const int nb = T / BN;
  const int npairs = nb * (nb + 1) / 2;
  const int z = blockIdx.z;
  const bool live = z < n_live;
  // one block per row range writes the stats out
  const bool writer = z == 0 && blockIdx.x == 0;
  if (!live && !writer) return;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * per;
  const long long r_end = min(r_begin + per, n);
  const TileRows<F> src{r_begin, r_end, y, xb, weights, offset,
                        loss, s_out, w_out, writer};
  if (!live) {   // no live tile: the stats alone
    float wv, sv;
    for (long long i = r_begin + threadIdx.x; i < r_end; i += blockDim.x)
      src.stats_row(src.fetch_row(i), i, wv, sv);
    return;
  }
  int bi, bj;
  repro::gram::pair_coords(blockIdx.x, nb, bi, bj);
  const long long slot = (long long)split * n_live + z;
  const long long rows = r_end > r_begin ? r_end - r_begin : 0;
  repro::gram::band<BN>(src, &X, order[z] * T,
                        (int)((rows + kSlab - 1) / kSlab), bi * BN, bj * BN,
                        bi == bj,
                        Gp + (slot * npairs + blockIdx.x) * BN * BN,
                        gp + slot * T + bi * BN);
}

__global__ void sgs_reduce(const float* __restrict__ Gp,
                           const float* __restrict__ gp,
                           const int* __restrict__ order, int n_live, int nt,
                           int splits, int T, int BN, float* __restrict__ G,
                           float* __restrict__ g) {
  const int nb = T / BN;
  const long long block = (long long)BN * BN;
  const long long npairs = nb * (nb + 1) / 2;
  const long long per_tile = (long long)T * T + T;
  const long long total = per_tile * nt;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int z = (int)(idx / per_tile);
    const long long rem = idx % per_tile;
    const long long tile = order[z];
    const bool live = z < n_live;
    float tot = 0.f;
    if (rem < (long long)T * T) {
      if (live) {
        int i = (int)(rem / T), j = (int)(rem % T);
        if (i > j) {   // the lower triangle mirrors the upper one
          const int t = i;
          i = j;
          j = t;
        }
        const long long off =
            repro::gram::pair_index(i / BN, j / BN, nb) * block +
            (i % BN) * BN + j % BN;
        for (int s = 0; s < splits; ++s)
          tot += Gp[((long long)s * n_live + z) * npairs * block + off];
      }
      G[tile * T * T + rem] = tot;
    } else {
      const long long j = rem - (long long)T * T;
      if (live)
        for (int s = 0; s < splits; ++s)
          tot += gp[((long long)s * n_live + z) * T + j];
      g[tile * T + j] = tot;
    }
  }
}

__global__ void sgs_solve(const float* __restrict__ G,
                          const float* __restrict__ g,
                          const float* __restrict__ beta,
                          const float* __restrict__ penf,
                          const float* __restrict__ params,
                          const int* __restrict__ order, int n_live, int T,
                          float* __restrict__ dbeta) {
  extern __shared__ float delta_s[];
  const int z = blockIdx.x;
  const long long tile = order[z];
  const int k = threadIdx.x;
  const long long c = tile * T + k;
  if (z >= n_live) {
    dbeta[c] = 0.f;
    return;
  }
  const float* Gt = G + tile * T * T;
  dbeta[c] = repro::cd_chain(Gt, g[c], Gt[(long long)k * T + k], beta[c],
                             0.f, penf[c], params[0], params[1], params[2],
                             params[3], delta_s, T, k);
}

template <int F, int BN>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const float* X,
                           long long n, int p, int T, const float* y,
                           const float* xb, const float* weights,
                           const float* offset, const int* order, int n_live,
                           int per, float* Gp, float* gp, float* loss,
                           float* s, float* w) {
  constexpr size_t smem = repro::gram::smem_bytes<BN>();
  cudaError_t err = repro::gram::allow_smem(sgs_partial<F, BN>, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = repro::gram::make_map(&map, X, n, p, p);
  if (err != cudaSuccess) return err;
  sgs_partial<F, BN><<<grid, repro::gram::threads<BN>(), smem, st>>>(
      map, n, T, y, xb, weights, offset, order, n_live, per, Gp, gp, loss,
      s, w);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_family(int band, dim3 grid, cudaStream_t st,
                          const float* X, long long n, int p, int T,
                          const float* y, const float* xb,
                          const float* weights, const float* offset,
                          const int* order, int n_live, int per, float* Gp,
                          float* gp, float* loss, float* s, float* w) {
  return band == 128
             ? launch_partial<F, 128>(grid, st, X, n, p, T, y, xb, weights,
                                      offset, order, n_live, per, Gp, gp,
                                      loss, s, w)
             : launch_partial<F, 64>(grid, st, X, n, p, T, y, xb, weights,
                                     offset, order, n_live, per, Gp, gp,
                                     loss, s, w);
}

}  // namespace

// X: (n, p) row-major and 16-byte aligned, p = nt * T; y, xb, weights,
// offset (may be null), loss, s, w: (n,); beta, penf, dbeta: (p,);
// params: device (4,) [mu, nu, lam1, lam2]; order: (nt,) live tiles
// first; G (nt, T, T), g (nt, T).
// band: the block edge BN (128, or 64; T a multiple of it, at most 1024).
// Scratch Gp (splits * max(n_live, 1) * npairs * BN * BN, npairs = nb (nb
// + 1) / 2 with nb = T / BN) and gp (splits * max(n_live, 1) * T) from the
// caller; rows [s * per, (s + 1) * per) go to range s, per a multiple of 32.
extern "C" int repro_stats_gram_solve(
    const float* X, long long n, int p, int T, const float* y,
    const float* xb, const float* weights, const float* offset,
    const float* beta, const float* penf, const float* params,
    const int* order, int n_live, int splits, int per, int band, float* Gp,
    float* gp, float* loss, float* s, float* w, float* G, float* g,
    float* dbeta, int family, void* stream) {
  if (T <= 0 || (band != 64 && band != 128) || T % band != 0 || T > 1024 ||
      p % T != 0 || splits <= 0 || per <= 0 || per % kSlab != 0 ||
      n_live < 0 || n_live > p / T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = p / T;
  const int nb = T / band;
  dim3 grid(nb * (nb + 1) / 2, splits, n_live > 0 ? n_live : 1);
  cudaError_t err;
  switch (family) {
    case repro::kLogistic:
      err = launch_family<repro::kLogistic>(band, grid, st, X, n, p, T, y,
                                            xb, weights, offset, order,
                                            n_live, per, Gp, gp, loss, s, w);
      break;
    case repro::kSquared:
      err = launch_family<repro::kSquared>(band, grid, st, X, n, p, T, y, xb,
                                           weights, offset, order, n_live,
                                           per, Gp, gp, loss, s, w);
      break;
    case repro::kProbit:
      err = launch_family<repro::kProbit>(band, grid, st, X, n, p, T, y, xb,
                                          weights, offset, order, n_live,
                                          per, Gp, gp, loss, s, w);
      break;
    case repro::kPoisson:
      err = launch_family<repro::kPoisson>(band, grid, st, X, n, p, T, y, xb,
                                           weights, offset, order, n_live,
                                           per, Gp, gp, loss, s, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = ((long long)T * T + T) * nt;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sgs_reduce<<<(int)blocks, 256, 0, st>>>(Gp, gp, order, n_live, nt, splits,
                                          T, band, G, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgs_solve<<<nt, T, T * sizeof(float), st>>>(G, g, beta, penf, params,
                                               order, n_live, T, dbeta);
  return (int)cudaGetLastError();
}
