// The sLSTM scan over a whole sequence, every (batch row, head) in one
// launch.
//
// Replaces no Pallas kernel: it is the port of the reference's
// src/repro/models/xlstm.py::slstm_apply's lax.scan of _slstm_step
// (:205-243), which XLA compiles into one loop (a Python loop costs about
// twenty launches a step).  For each (b, h), with c, n, h (hd,) and the
// head-level stabilizer m, and t in order:
//   pre_g = g_t,g + h r_g  (g = z, i, f, o; r_g (hd, hd))
//   i_sc, f_sc = the means of pre_i, pre_f over hd
//   log_f = -softplus(-f_sc);  m' = max(log_f + m, i_sc)
//   i_g = exp(pre_i - m');  f_g = exp(log_f + (m - m'))
//   c = f_g c + i_g tanh(pre_z);  n = f_g n + i_g
//   h = sigmoid(pre_o) c / max(n, 1e-6)
// Decode is the same kernel at S = 1, from the cache's state.
//
// Bound on the card: the recurrent product, 8 hd^2 flops a step and (b,
// h): about 11.8 GFLOP for xlstm-1.3b's 704-token prefill (B 2, H 4, hd
// 512), 0.18 ms at 67 TFLOP/s; but every step needs the whole h of the
// step before, so each (b, h) is a chain of S steps, each a product with
// r's 4 MB a head (float32), which no SM holds.  Design: a thread block
// cluster a (b, h), each block owning a slice of W (32, or 64 where the
// card cannot schedule a cluster of hd / 32) columns of hd for all four
// gates.  A step reads the block's slice of r (4 hd W floats: 256 KB at
// hd 512, from L2, where the 16 MB of r stay), forms its columns' pre
// (its 256 threads split the sum over hd in two where W is 32), sums its
// columns of pre_i and pre_f, and meets the cluster at a barrier; every
// block then adds the C partial sums over distributed shared memory in
// the same order (the same m' bit for bit), updates its columns' c, n and
// h, and meets the cluster again to gather the whole h.  On a model axis
// past 1 the caller gathers h over ranks every step and launches one step
// at a time, with the stabilizers' sums over the whole hd given (sc).  The
// updates are rounded as the plain version's (products and sums apart: no
// fused multiply-add); the products with r and the means are float32
// sums in another order.  max propagates NaN, as torch.maximum and
// torch.clamp_min do, so exp's overflows give the plain loop's inf and
// NaN.  Training mode (pre not null): every step's gate pre-activations
// (B, steps, 4, H, hd_v), c and n (B, steps, H, hd_v) and m (B, steps, H)
// are also written, for slstm_scan_bwd.cu; serving passes null.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHdK = 512;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  const float nx = -x;
  return -(nx > 20.f ? nx : log1pf(expf(nx)));
}

// W columns of hd a block; 256 / (4 W) threads share a column's sum
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_kernel(const float* __restrict__ gates,
                      const float* __restrict__ r, const float* c_in,
                      const float* n_in, const float* h_in,
                      const float* m_in, const float* __restrict__ sc,
                      float* __restrict__ hs, float* c_out, float* n_out,
                      float* h_out, float* m_out, float* __restrict__ pre,
                      float* __restrict__ cs, float* __restrict__ ns,
                      float* __restrict__ ms, int S, int steps, int H,
                      int hd_k, int hd_v) {
  constexpr int KP = kThreads / (4 * W);   // 2 (W 32) or 1 (W 64)
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = tid % W, g = (tid / W) & 3, kp = tid / (4 * W);
  const int v0 = rank * W;
  const int col = v0 + vl;
  const bool col_ok = col < hd_v;

  __shared__ float hfull[kMaxHdK];
  __shared__ float part[4][W];     // the second half's sums (KP 2)
  __shared__ float pre_s[4][W];
  __shared__ float psum[2];        // this block's sums of pre_i, pre_f
  __shared__ float hslice[W];      // this block's columns of h

  for (int kk = tid; kk < hd_k; kk += kThreads)
    hfull[kk] = h_in[(long long)bh * hd_k + kk];
  float c = 0.f, n = 0.f, hv = 0.f;
  if (tid < W && col_ok) {
    c = c_in[(long long)bh * hd_v + col];
    n = n_in[(long long)bh * hd_v + col];
    hv = h_in[(long long)bh * hd_k + col];
  }
  float m = m_in[bh];
  const float* rg = r + ((long long)h * 4 + g) * hd_k * hd_v + col;
  const int kh = (hd_k + KP - 1) / KP;
  const int k_lo = kp * kh, k_hi = min(hd_k, k_lo + kh);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    // this thread's share of (h r_g) at its column
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (col_ok) {
      int kk = k_lo;
      for (; kk + 4 <= k_hi; kk += 4) {
        a0 = fmaf(hfull[kk], rg[(long long)kk * hd_v], a0);
        a1 = fmaf(hfull[kk + 1], rg[(long long)(kk + 1) * hd_v], a1);
        a2 = fmaf(hfull[kk + 2], rg[(long long)(kk + 2) * hd_v], a2);
        a3 = fmaf(hfull[kk + 3], rg[(long long)(kk + 3) * hd_v], a3);
      }
      for (; kk < k_hi; ++kk) a0 = fmaf(hfull[kk], rg[(long long)kk * hd_v], a0);
    }
    float acc = (a0 + a1) + (a2 + a3);
    if (KP == 2) {
      if (kp == 1) part[g][vl] = acc;
      __syncthreads();
    }
    if (kp == 0) {
      if (KP == 2) acc += part[g][vl];
      const long long gi =
          ((((long long)b * S + t) * 4 + g) * H + h) * hd_v + col;
      pre_s[g][vl] = col_ok ? __fadd_rn(gates[gi], acc) : 0.f;
      if (pre != nullptr && col_ok)
        pre[((((long long)b * steps + t) * 4 + g) * H + h) * hd_v + col] =
            pre_s[g][vl];
    }
    __syncthreads();
    if (sc == nullptr && warp < 2) {   // warp 0: pre_i, warp 1: pre_f
      float s = 0.f;
      for (int q = lane; q < W; q += 32) s += pre_s[1 + warp][q];
      s = warp_sum(s);
      if (lane == 0) psum[warp] = s;
    }
    cluster.sync();
    float i_sc, f_sc;
    if (sc == nullptr) {
      float ti = 0.f, tf = 0.f;
      for (int q = 0; q < CL; ++q) {
        const float* ps = cluster.map_shared_rank(psum, q);
        ti += ps[0];
        tf += ps[1];
      }
      i_sc = ti / (float)hd_k;
      f_sc = tf / (float)hd_k;
    } else {
      i_sc = sc[((long long)b * 2) * H + h];
      f_sc = sc[((long long)b * 2 + 1) * H + h];
    }
    const float log_f = log_sigmoid(f_sc);
    const float m_new = nan_max(__fadd_rn(log_f, m), i_sc);
    if (tid < W && col_ok) {
      const float zp = pre_s[0][vl], ip = pre_s[1][vl], op = pre_s[3][vl];
      const float i_g = expf(__fsub_rn(ip, m_new));
      const float f_g = expf(__fadd_rn(log_f, __fsub_rn(m, m_new)));
      const float z = tanhf(zp);
      const float o = 1.f / (1.f + expf(-op));
      c = __fadd_rn(__fmul_rn(f_g, c), __fmul_rn(i_g, z));
      n = __fadd_rn(__fmul_rn(f_g, n), i_g);
      const float nc = isnan(n) ? n : fmaxf(n, 1e-6f);
      hv = __fmul_rn(o, c) / nc;
      hslice[vl] = hv;
      const long long at = (((long long)b * steps + t) * H + h) * hd_v + col;
      hs[at] = hv;
      if (pre != nullptr) {
        cs[at] = c;
        ns[at] = n;
      }
    }
    if (pre != nullptr && rank == 0 && tid == 0)
      ms[((long long)b * steps + t) * H + h] = m_new;
    m = m_new;
    if (t + 1 < steps) {
      cluster.sync();            // every block's h slice written
      for (int kk = tid; kk < hd_k; kk += kThreads)
        hfull[kk] = *cluster.map_shared_rank(&hslice[kk % W], kk / W);
      __syncthreads();
    }
  }
  if (tid < W && col_ok) {
    c_out[(long long)bh * hd_v + col] = c;
    n_out[(long long)bh * hd_v + col] = n;
    h_out[(long long)bh * hd_v + col] = hv;
  }
  if (rank == 0 && tid == 0) m_out[bh] = m;
  cluster.sync();   // no block leaves while another may read its slots
}

const repro::KernelSlot kSlots[] = {
    {(const void*)slstm_scan_kernel<32>, "slstm_scan_kernel<32>"},
    {(const void*)slstm_scan_kernel<64>, "slstm_scan_kernel<64>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

// The configuration of a cluster of c blocks of fn over B H heads.
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

// Columns a block and cluster size for hd_v: W 32 and hd_v / 32 blocks
// where the card schedules that cluster, else W 64.
cudaError_t plan(int hd_v, int& W, int& C) {
  static const int widths[] = {32, 64};
  cudaError_t err = cudaErrorInvalidConfiguration;
  for (int w : widths) {
    const int c = (hd_v + w - 1) / w;
    if (c > kMaxCluster) continue;
    const void* fn = w == 32 ? (const void*)slstm_scan_kernel<32>
                             : (const void*)slstm_scan_kernel<64>;
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

// hs (B, steps, H, hd_v) and the final c_out, n_out, h_out (B, H, hd_v),
// m_out (B, H): the scan of the first `steps` positions of gates (B, S, 4,
// H, hd_v) with r (H, 4, hd_k, hd_v), from c_in, n_in (B, H, hd_v), h_in
// (B, H, hd_k: the whole h) and m_in (B, H).  sc (B, 2, H), or null: the
// head-level i and f of one step (steps 1), given where a block of hd runs
// here.  The outputs may be the inputs (every read of an input precedes a
// cluster barrier that precedes every write).  pre, cs, ns, ms: null, or
// the training mode's every step's gate pre-activations, c, n and m.
extern "C" int repro_slstm_scan(const float* gates, const float* r,
                                const float* c_in, const float* n_in,
                                const float* h_in, const float* m_in,
                                const float* sc, float* hs, float* c_out,
                                float* n_out, float* h_out, float* m_out,
                                float* pre, float* cs, float* ns, float* ms,
                                int B, int S, int steps, int H, int hd_k,
                                int hd_v, void* stream) {
  if (B < 1 || S < 1 || steps < 1 || steps > S || H < 1 || hd_k < 1 ||
      hd_v < 1 || hd_k > kMaxHdK || (sc == nullptr && hd_k != hd_v) ||
      (sc != nullptr && steps != 1) ||
      (pre != nullptr && (!cs || !ns || !ms)))
    return (int)cudaErrorInvalidValue;
  int W = 32, C = 1;
  cudaError_t err = plan(hd_v, W, C);
  if (err != cudaSuccess) return (int)err;
  const void* fn = W == 32 ? (const void*)slstm_scan_kernel<32>
                           : (const void*)slstm_scan_kernel<64>;
  if ((err = repro::note_launch(kSlots, kMax, fn, 0, kThreads)) !=
      cudaSuccess)
    return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(C, B * H, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&gates, &r,     &c_in,  &n_in,  &h_in, &m_in,
                  &sc,    &hs,    &c_out, &n_out, &h_out, &m_out,
                  &pre,   &cs,    &ns,    &ms,    &S,    &steps,
                  &H,     &hd_k,  &hd_v};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan's columns a block and cluster size for hd_v on this card.
extern "C" int repro_slstm_scan_plan(int hd_v, int* W, int* C) {
  return (int)plan(hd_v, *W, *C);
}

REPRO_RESOURCES_ENTRY(slstm_scan)
