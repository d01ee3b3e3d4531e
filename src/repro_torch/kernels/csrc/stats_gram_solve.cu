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
// Bound on the card: operations.  G_t is symmetric, so the least work is
// its T (T + 1) / 2 unique entries, n T (T + 1) flops a tile against n T 4
// bytes of X: about T / 4 = 64 flops per byte at T = 256, far above the
// ratio of fp32 flops to bytes.  TF32 is ruled out (the solver holds beta
// to 1e-5), so this runs on the fp32 FMA pipes.
//
// Design.  The TPU kernel walked a sequential grid (tile, row block) over a
// tile-major copy of X and carried G in VMEM.  Here X is read in place from
// the row-major array (tile t of row i is 1 KiB contiguous at T = 256), and
// the work is cut three ways so a handful of tiles still fills 132 SMs:
// live tile x 64 x 64 sub-tile of G x range of rows.  Only the sub-tiles on
// and above the diagonal are computed (10 of 16 at T = 256); the reduction
// mirrors them.  Three CUDA launches make one logical launch:
//   1. sgs_partial: each block stages 32-row slabs of its two 64-column
//      ranges in shared memory, forms (loss, s, w) of those rows inline
//      from (y, xb, offset, weights) -- one block per row range writes them
//      out, so they leave once, not once per tile -- scales one slab by w
//      and accumulates a 4 x 4 register tile per thread; diagonal blocks
//      also accumulate g.  Partials go to a workspace.  A row range is
//      thousands of rows of near-equal terms (the intercept column sums
//      w_i alone), and one running float32 sum over them drifts by up to
//      rows x 6e-8 of the sum, about 1e-3 at 12,500 rows; so the sums are
//      kept in three levels -- a slab of 32 rows, 16 slabs, the range (in
//      shared memory) -- which holds the drift near 1e-6.
//   2. sgs_reduce: adds the partials of each G and g entry in row-range
//      order (no atomics: the same sums every run) and writes dead tiles'
//      G and g as zeros.
//   3. sgs_solve: one block of T threads per tile runs the chain on the
//      tile's G (h = diag G) from a zero step; dead tiles write 0.
// ``order`` is the tile remap of the TPU kernel's scalar prefetch: live
// tiles first, then dead ones; blocks past n_live do no Gram or solve work.
#include <cuda_runtime.h>

#include "cd_chain.cuh"
#include "glm_family.cuh"

namespace {

constexpr int kSub = 64;       // G sub-tile edge; T must be a multiple
constexpr int kRows = 32;      // rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSlabsPerMid = 16;  // slab sums folded into a middle sum

// (bi, bj), bi <= bj, of upper-triangle sub-tile pair ``pair`` (row-major)
__device__ inline void pair_coords(int pair, int nsub, int& bi, int& bj) {
  bi = 0;
  while (pair >= nsub - bi) {
    pair -= nsub - bi;
    ++bi;
  }
  bj = bi + pair;
}

__device__ inline int pair_index(int bi, int bj, int nsub) {
  return bi * nsub - bi * (bi - 1) / 2 + (bj - bi);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    sgs_partial(const float* __restrict__ X, long long n, int p, int T,
                const float* __restrict__ y, const float* __restrict__ xb,
                const float* __restrict__ weights,
                const float* __restrict__ offset,
                const int* __restrict__ order, int n_live, int per,
                float* __restrict__ Gp, float* __restrict__ gp,
                float* __restrict__ loss, float* __restrict__ s_out,
                float* __restrict__ w_out) {
  __shared__ __align__(16) float As[kRows][kSub];
  __shared__ __align__(16) float Bs[kRows][kSub];
  __shared__ float ws[kRows];
  __shared__ float ss[kRows];
  __shared__ float tot_s[16][kThreads];   // the range sums, one per output

  const int nsub = T / kSub;
  const int npairs = nsub * (nsub + 1) / 2;
  const int z = blockIdx.z;
  const bool live = z < n_live;
  // one block per row range writes the stats out
  const bool writer = z == 0 && blockIdx.x == 0;
  if (!live && !writer) return;
  int bi, bj;
  pair_coords(blockIdx.x, nsub, bi, bj);
  const bool diag = bi == bj;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * per;
  const long long r_end = min(r_begin + per, n);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long c0 = live ? (long long)order[z] * T : 0;
  const int ci = bi * kSub;
  const int cj = bj * kSub;

  float mid[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      mid[a][b] = 0.f;
      tot_s[a * 4 + b][tid] = 0.f;
    }
  float gmid = 0.f, gtot = 0.f;
  int nslab = 0;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (tid < kRows) {
      const long long i = r0 + tid;
      float wi = 0.f, si = 0.f;
      if (i < r_end) {
        float m = xb[i];
        if (offset != nullptr) m = m + offset[i];
        float l;
        repro::Stats<F>::all(y[i], m, l, si, wi);
        const float c = weights[i];
        l = l * c;
        si = si * c;
        wi = wi * c;
        if (writer) {
          loss[i] = l;
          s_out[i] = si;
          w_out[i] = wi;
        }
      }
      ws[tid] = wi;
      ss[tid] = si;
    }
    if (live) {
#pragma unroll
      for (int e = tid; e < kRows * kSub; e += kThreads) {
        const int rr = e / kSub;
        const int cc = e % kSub;
        const bool in = r0 + rr < r_end;
        const float* src = X + (r0 + rr) * p + c0;
        As[rr][cc] = in ? src[ci + cc] : 0.f;
        Bs[rr][cc] = in ? src[cj + cc] : 0.f;
      }
    }
    __syncthreads();
    if (live) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kRows; ++kk) {
        const float wk = ws[kk];
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[4] = {av.x * wk, av.y * wk, av.z * wk, av.w * wk};
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += a[ii] * b[jj];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mid[ii][jj] += acc[ii][jj];
      if (diag && tid < kSub) {
        float gacc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < kRows; ++kk) gacc += Bs[kk][tid] * ss[kk];
        gmid += gacc;
      }
      if (++nslab == kSlabsPerMid) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            tot_s[ii * 4 + jj][tid] += mid[ii][jj];
            mid[ii][jj] = 0.f;
          }
        gtot += gmid;
        gmid = 0.f;
        nslab = 0;
      }
    }
    __syncthreads();
  }
  if (!live) return;
  gtot += gmid;

  float* out = Gp + (((long long)split * n_live + z) * npairs + blockIdx.x) *
                        (kSub * kSub);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float v[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      v[jj] = tot_s[ii * 4 + jj][tid] + mid[ii][jj];
    *reinterpret_cast<float4*>(&out[(ty * 4 + ii) * kSub + tx * 4]) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  if (diag && tid < kSub)
    gp[((long long)split * n_live + z) * T + ci + tid] = gtot;
}

__global__ void sgs_reduce(const float* __restrict__ Gp,
                           const float* __restrict__ gp,
                           const int* __restrict__ order, int n_live, int nt,
                           int splits, int T, float* __restrict__ G,
                           float* __restrict__ g) {
  const int nsub = T / kSub;
  const int npairs = nsub * (nsub + 1) / 2;
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
      int i = (int)(rem / T);
      int j = (int)(rem % T);
      if (live) {
        int bi = i / kSub, bj = j / kSub, ii = i % kSub, jj = j % kSub;
        if (bi > bj) {  // the lower sub-tiles mirror the upper ones
          int t = bi; bi = bj; bj = t;
          t = ii; ii = jj; jj = t;
        }
        const long long off =
            (long long)pair_index(bi, bj, nsub) * (kSub * kSub) + ii * kSub +
            jj;
        for (int s = 0; s < splits; ++s)
          tot += Gp[((long long)s * n_live + z) * npairs * (kSub * kSub) +
                    off];
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

}  // namespace

// X: (n, p) row-major, p = nt * T; y, xb, weights, offset (may be null),
// loss, s, w: (n,); beta, penf, dbeta: (p,); params: device (4,) [mu, nu,
// lam1, lam2]; order: (nt,) live tiles first; G (nt, T, T), g (nt, T).
// Scratch Gp (splits * max(n_live, 1) * npairs * 64 * 64) and gp (splits *
// max(n_live, 1) * T) from the caller; rows [s * per, (s + 1) * per) go to
// range s, per a multiple of 32.  T a multiple of 64, at most 1024.
extern "C" int repro_stats_gram_solve(
    const float* X, long long n, int p, int T, const float* y,
    const float* xb, const float* weights, const float* offset,
    const float* beta, const float* penf, const float* params,
    const int* order, int n_live, int splits, int per, float* Gp, float* gp,
    float* loss, float* s, float* w, float* G, float* g, float* dbeta,
    int family, void* stream) {
  if (T <= 0 || T % kSub != 0 || T > 1024 || p % T != 0 || splits <= 0 ||
      per <= 0 || per % kRows != 0 || n_live < 0 || n_live > p / T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = p / T;
  const int nsub = T / kSub;
  dim3 grid(nsub * (nsub + 1) / 2, splits, n_live > 0 ? n_live : 1);
  switch (family) {
    case repro::kLogistic:
      sgs_partial<repro::kLogistic><<<grid, kThreads, 0, st>>>(
          X, n, p, T, y, xb, weights, offset, order, n_live, per, Gp, gp,
          loss, s, w);
      break;
    case repro::kSquared:
      sgs_partial<repro::kSquared><<<grid, kThreads, 0, st>>>(
          X, n, p, T, y, xb, weights, offset, order, n_live, per, Gp, gp,
          loss, s, w);
      break;
    case repro::kProbit:
      sgs_partial<repro::kProbit><<<grid, kThreads, 0, st>>>(
          X, n, p, T, y, xb, weights, offset, order, n_live, per, Gp, gp,
          loss, s, w);
      break;
    case repro::kPoisson:
      sgs_partial<repro::kPoisson><<<grid, kThreads, 0, st>>>(
          X, n, p, T, y, xb, weights, offset, order, n_live, per, Gp, gp,
          loss, s, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = ((long long)T * T + T) * nt;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sgs_reduce<<<(int)blocks, 256, 0, st>>>(Gp, gp, order, n_live, nt, splits,
                                          T, G, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgs_solve<<<nt, T, T * sizeof(float), st>>>(G, g, beta, penf, params,
                                               order, n_live, T, dbeta);
  return (int)cudaGetLastError();
}
