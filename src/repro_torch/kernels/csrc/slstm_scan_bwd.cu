// The backward of the sLSTM scan: every (batch row, head) in one launch
// (a thread block cluster a head), its time steps in reverse.
//
// Replaces no Pallas kernel: it is the transpose of the reference's
// src/repro/models/xlstm.py::slstm_apply's lax.scan of _slstm_step
// (:205-243), the reverse-time loop XLA compiles for its jax.vjp.  For
// each (b, h), with dc, dn (hd_v) and dm carried and t from the last step
// (nc = max(n_t, 1e-6)):
//   dh = dh_t + dh_rec;  dc += dh o / nc;  dn -= dh h_t / nc [n_t >= 1e-6]
//   dpre_o = dh c_t / nc o (1 - o);  dpre_z = dc i_g (1 - z^2)
//   dpre_i = (dc z + dn) i_g;  df_g = <dc, c_{t-1}> + <dn, n_{t-1}>
//   dc *= f_g;  dn *= f_g
// then the head-level stabilizer's scalar chain through f_g = e^(log_f +
// m_{t-1} - m_t), i_g's e^-m_t and m_t = max(log_f + m_{t-1}, i_sc) (half
// the gradient to each side at a tie, as torch.maximum's), into d i_sc and
// d f_sc, spread over hd through the means (dpre_i += d i_sc / hd, dpre_f =
// d f_sc / hd), or into dsc where the caller gave sc; and dh_rec for the
// step before, sum_g r_g dpre_g.  The forward's training mode
// (slstm_scan.cu) saved every step's gate pre-activations, c, n and m, and
// its outputs are every step's h: nothing is recomputed but the cell's
// elementwise values and the means, in the forward's own order (the same
// bits).  dr_gates = sum over rows and steps of h_{t-1} dpre_t is one
// product after this kernel (kernels/slstm_scan.py).
//
// Bound on the card: the recurrent product, 8 hd^2 flops a step and (b,
// h), as the forward's; each (b, h) is a chain of S steps, each a product
// with r's 4 MB a head.  Design: the forward's cluster, each block owning W
// columns of hd for the cell and the same W rows of r for dh_rec (on a
// model axis past 1, with sc given and one step, ceil(hd_k / blocks) rows
// of the whole h).  A step: the block's columns' cell gradients and their
// four sums (pre_i and pre_f for the means, df_g's and the i_g chain's),
// summed over the cluster through distributed shared memory in one order
// (the same bits in every block); the scalar chain in every block; the
// block's dpre staged in shared memory, gathered whole by every block
// (dh_{t-1} needs all of it), and the block's rows of r times it (a warp a
// row, its lanes along hd_v: coalesced reads of r from L2).  No float
// atomics: two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHdK = 512;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  const float nx = -x;
  return -(nx > 20.f ? nx : log1pf(expf(nx)));
}

__device__ __forceinline__ float dlog_sigmoid(float x) {
  const float nx = -x;
  if (nx > 20.f) return 1.f;
  const float z = expf(nx);
  return z / (z + 1.f);
}

__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// W columns of hd_v a block
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_bwd_kernel(const float* __restrict__ r,
                          const float* __restrict__ c0,
                          const float* __restrict__ n0,
                          const float* __restrict__ m0,
                          const float* __restrict__ sc,
                          const float* __restrict__ pre,
                          const float* __restrict__ cs,
                          const float* __restrict__ ns,
                          const float* __restrict__ ms,
                          const float* __restrict__ hs,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dc_in,
                          const float* __restrict__ dn_in,
                          const float* __restrict__ dh_in,
                          const float* __restrict__ dm_in,
                          float* __restrict__ dpre, float* __restrict__ dc0,
                          float* __restrict__ dn0, float* __restrict__ dh0,
                          float* __restrict__ dm0, float* __restrict__ dsc,
                          int steps, int H, int hd_k, int hd_v) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = rank * W + tid;
  const bool cell = tid < W;
  const bool col_ok = cell && col < hd_v;
  // this block's rows of r for dh_rec: its own columns, or a share of the
  // whole h where sc is given (hd_k > hd_v on a model axis past 1)
  const int KW = sc == nullptr ? W : (hd_k + CL - 1) / CL;
  const int k0 = rank * KW, k1 = min(hd_k, k0 + KW);

  __shared__ float dpre_full[4][kMaxHdK];
  __shared__ float dhrec[kMaxHdK];
  __shared__ float pre_s[4][W];
  __shared__ float part_s[2][W];
  __shared__ float psum[4];        // this block's sums: pre_i, pre_f, df_g, i
  __shared__ float dpre_s[4][W];   // this block's dpre, read by the cluster

  float dc = 0.f, dn = 0.f;
  if (cell) {
    dc = col_ok ? dc_in[(long long)bh * hd_v + col] : 0.f;
    dn = col_ok ? dn_in[(long long)bh * hd_v + col] : 0.f;
    dhrec[tid] = col_ok ? dh_in[(long long)bh * hd_v + col] : 0.f;
  }
  float dm = dm_in[bh];
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const long long srow = ((long long)b * steps + t) * H + h;
    const float m_t = ms[srow];
    const float m_p = t ? ms[srow - H] : m0[bh];
    const long long o = srow * hd_v + col;
    float dpz = 0.f, dpo = 0.f, dpi0 = 0.f;
    if (cell) {
      if (col_ok) {
        float pg[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          pg[g] = pre[((((long long)b * steps + t) * 4 + g) * H + h) * hd_v +
                      col];
          pre_s[g][tid] = pg[g];
        }
        const float c_t = cs[o], n_t = ns[o];
        const float c_p = t ? cs[o - (long long)H * hd_v]
                            : c0[(long long)bh * hd_v + col];
        const float n_p = t ? ns[o - (long long)H * hd_v]
                            : n0[(long long)bh * hd_v + col];
        const float dht = dhs[o] + dhrec[tid];
        const float i_g = expf(__fsub_rn(pg[1], m_t));
        const float z = tanhf(pg[0]);
        const float og = 1.f / (1.f + expf(-pg[3]));
        const float nc = isnan(n_t) ? n_t : fmaxf(n_t, 1e-6f);
        dc += dht * og / nc;
        if (n_t >= 1e-6f) dn -= dht * hs[o] / nc;
        dpo = dht * c_t / nc * (og * (1.f - og));
        dpz = dc * i_g * (1.f - z * z);
        dpi0 = (dc * z + dn) * i_g;
        part_s[0][tid] = dc * c_p + dn * n_p;
        part_s[1][tid] = dpi0;
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) pre_s[g][tid] = 0.f;
        part_s[0][tid] = 0.f;
        part_s[1][tid] = 0.f;
      }
    }
    __syncthreads();
    // warp 0: pre_i, warp 1: pre_f (the forward's sums, in its order),
    // warp 2: df_g's, warp 3: the i_g chain's
    if (warp < 4) {
      const float* src = warp < 2 ? pre_s[1 + warp] : part_s[warp - 2];
      float s = 0.f;
      for (int q = lane; q < W; q += 32) s += src[q];
      s = warp_sum(s);
      if (lane == 0) psum[warp] = s;
    }
    cluster.sync();
    float ti = 0.f, tf = 0.f, dfg = 0.f, dsi = 0.f;
    for (int q = 0; q < CL; ++q) {
      const float* ps = cluster.map_shared_rank(psum, q);
      ti += ps[0];
      tf += ps[1];
      dfg += ps[2];
      dsi += ps[3];
    }
    float i_sc, f_sc;
    if (sc == nullptr) {
      i_sc = ti / (float)hd_k;
      f_sc = tf / (float)hd_k;
    } else {
      i_sc = sc[((long long)b * 2) * H + h];
      f_sc = sc[((long long)b * 2 + 1) * H + h];
    }
    const float log_f = log_sigmoid(f_sc);
    const float a = __fadd_rn(log_f, m_p);
    const float f_g = expf(__fadd_rn(log_f, __fsub_rn(m_p, m_t)));
    const float dsf = dfg * f_g;
    dm = dm - dsi - dsf;
    const float w_a = max_share(a, i_sc);
    const float da = dm * w_a, di_sc = dm * (1.f - w_a);
    const float df_sc = (dsf + da) * dlog_sigmoid(f_sc);
    dm = dsf + da;
    if (cell) {
      float dp[4] = {dpz, dpi0, 0.f, dpo};
      if (col_ok) {
        if (sc == nullptr) {
          dp[1] += di_sc / (float)hd_v;
          dp[2] = df_sc / (float)hd_v;
        }
        dc *= f_g;
        dn *= f_g;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dpre[((((long long)b * steps + t) * 4 + g) * H + h) * hd_v + col] =
              dp[g];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dpre_s[g][tid] = col_ok ? dp[g] : 0.f;
    }
    if (sc != nullptr && rank == 0 && tid == 0) {
      dsc[((long long)b * 2) * H + h] = di_sc;
      dsc[((long long)b * 2 + 1) * H + h] = df_sc;
    }
    cluster.sync();              // every block's dpre staged
    for (int i = tid; i < 4 * hd_v; i += kThreads) {
      const int g = i / hd_v, vv = i - g * hd_v;
      dpre_full[g][vv] = *cluster.map_shared_rank(&dpre_s[g][vv % W], vv / W);
    }
    __syncthreads();
    // dh_rec for this block's rows: sum_g r_g[k, :] . dpre_g
    for (int kk = k0 + warp; kk < k1; kk += kWarps) {
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* rr = r + (((long long)h * 4 + g) * hd_k + kk) * hd_v;
        for (int vv = lane; vv < hd_v; vv += 32)
          acc = fmaf(rr[vv], dpre_full[g][vv], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) dhrec[kk - k0] = acc;
    }
    __syncthreads();
  }
  if (col_ok) {
    dc0[(long long)bh * hd_v + col] = dc;
    dn0[(long long)bh * hd_v + col] = dn;
  }
  for (int kk = k0 + tid; kk < k1; kk += kThreads)
    dh0[(long long)bh * hd_k + kk] = dhrec[kk - k0];
  if (rank == 0 && tid == 0) dm0[bh] = dm;
  cluster.sync();   // no block leaves while another may read its slots
}

const repro::KernelSlot kSlots[] = {
    {(const void*)slstm_scan_bwd_kernel<32>, "slstm_scan_bwd_kernel<32>"},
    {(const void*)slstm_scan_bwd_kernel<64>, "slstm_scan_bwd_kernel<64>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

cudaLaunchConfig_t config(int c, int BH, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, BH);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Columns a block and cluster size for hd_v, as the forward's plan: W 32
// and hd_v / 32 blocks where the card schedules that cluster, else W 64.
cudaError_t plan(int hd_v, int& W, int& C) {
  static const int widths[] = {32, 64};
  cudaError_t err = cudaErrorInvalidConfiguration;
  for (int w : widths) {
    const int c = (hd_v + w - 1) / w;
    if (c > kMaxCluster) continue;
    const void* fn = w == 32 ? (const void*)slstm_scan_bwd_kernel<32>
                             : (const void*)slstm_scan_bwd_kernel<64>;
    if (c > 8 &&
        (err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(c, 1, nullptr, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();   // this size is refused; try the next
      continue;
    }
    if (clusters >= 1) {
      W = w;
      C = c;
      return cudaSuccess;
    }
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

}  // namespace

// The gradients of the scan (repro_slstm_scan) with r (H, 4, hd_k, hd_v)
// from c0, n0 (B, H, hd_v) and m0 (B, H), sc (B, 2, H) or null, from its
// training mode's pre (B, steps, 4, H, hd_v), cs, ns (B, steps, H, hd_v)
// and ms (B, steps, H), its output hs (B, steps, H, hd_v), and the
// cotangents dhs of hs and dc, dn, dh (B, H, hd_v), dm (B, H) of the final
// state: dpre (B, steps, 4, H, hd_v), dc0, dn0, dh0 (B, H, hd_k), dm0 and
// dsc (B, 2, H; null when sc is).
extern "C" int repro_slstm_scan_bwd(
    const float* r, const float* c0, const float* n0, const float* m0,
    const float* sc, const float* pre, const float* cs, const float* ns,
    const float* ms, const float* hs, const float* dhs, const float* dc,
    const float* dn, const float* dh, const float* dm, float* dpre,
    float* dc0, float* dn0, float* dh0, float* dm0, float* dsc, int B,
    int steps, int H, int hd_k, int hd_v, void* stream) {
  if (B < 1 || steps < 1 || H < 1 || hd_k < 1 || hd_v < 1 ||
      hd_k > kMaxHdK || (sc == nullptr && hd_k != hd_v) ||
      (sc != nullptr && (steps != 1 || dsc == nullptr)))
    return (int)cudaErrorInvalidValue;
  int W = 32, C = 1;
  cudaError_t err = plan(hd_v, W, C);
  if (err != cudaSuccess) return (int)err;
  const void* fn = W == 32 ? (const void*)slstm_scan_bwd_kernel<32>
                           : (const void*)slstm_scan_bwd_kernel<64>;
  if ((err = repro::note_launch(kSlots, kMax, fn, 0, kThreads)) !=
      cudaSuccess)
    return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(C, B * H, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&r,   &c0,  &n0,  &m0,  &sc,  &pre,  &cs,   &ns,
                  &ms,  &hs,  &dhs, &dc,  &dn,  &dh,   &dm,   &dpre,
                  &dc0, &dn0, &dh0, &dm0, &dsc, &steps, &H,   &hd_k,
                  &hd_v};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(slstm_scan_bwd)
