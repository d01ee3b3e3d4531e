// The backward of the mLSTM step scan: every (batch row, head) in one
// launch, its time steps in reverse.
//
// Replaces no Pallas kernel: it is the transpose of the reference's
// src/repro/models/xlstm.py::_mlstm_core (:52-76), the reverse-time loop
// XLA compiles for jax.vjp of its lax.scan of _mlstm_step.  For each
// (b, h), with dC = dL/dC_t (hd_k, hd_v), dn = dL/dn_t and t from the last
// step (den = max(|q.n|, e^-m), e = e^-m):
//   dnum = dh_t / den;  dden = -<dh_t, h_t> / den
//   d(q.n) = dden sign(q.n) [|q.n| > e];  dm_t -= e dden [e > |q.n|]
//   dC += q_t dnum^T;  dn += q_t d(q.n)
//   dq_t = C_t dnum + n_t d(q.n);  dk_t = i_g (dC v_t + dn)
//   dv_t = i_g dC^T k_t;  di_g = k_t^T (dC v_t + dn)
//   df_g = <dC, C_{t-1}> + <dn, n_{t-1}>;  dC *= f_g;  dn *= f_g
// then the stabilizer's scalar chain through i_g = e^(i - m_t), f_g =
// e^(log_f + m_{t-1} - m_t) and m_t = max(log_f + m_{t-1}, i), half the
// gradient to each side at a tie, as torch.maximum's.  The states come
// from the forward's training mode (mlstm_scan.cu): C and n before every
// L-th step, every step's m and q.n.  A segment's C and n are recomputed
// from its checkpoint with the forward's own rounding (products and sums
// apart), the same bits, into this block's slots of a scratch buffer
// (each thread reads back only what it wrote), then the segment runs in
// reverse.  No step divides by f_g: it goes to 0.
//
// Bound on the card: operations and the chain, as the forward.  C is 1 MB
// a (b, h) at hd 512.  Design: a (b, h) is split over blocks of 32 rows
// of C (16 blocks at hd_k 512), each keeping dC for its rows and all hd_v
// columns in registers (warp w the rows 4 w + r, lane l the columns l + 32
// j) and dn for its rows.  Split by rows, the sums over v (dq, dk, and
// <dh, h> for dden, read from the saved h) stay inside a warp, and only
// dv's sum over k and the two gate sums over C cross blocks: each block
// writes its partials (dv's times i_g), and mlstm_scan_bwd_reduce sums
// them in a fixed order, then runs the stabilizer's scalar chain (one
// thread a (b, h)) into di, df and dm0.  The dC and dn chains need none of
// it.  No float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRW = 4;                      // rows of C a warp
constexpr int kRows = kWarps * kRW;         // rows of C a block
constexpr int kMaxHdV = 512;
constexpr int kMaxL = 64;
constexpr int kRedW = kMaxHdV + 2;          // dv, then di_g and df_g
constexpr int kChunk = 512;                 // steps a pass of the reduce

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// -softplus(-x), torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float log_sigmoid(float x) {
  const float nx = -x;
  return -(nx > 20.f ? nx : log1pf(expf(nx)));
}

// its derivative, as torch's softplus backward gives it
__device__ __forceinline__ float dlog_sigmoid(float x) {
  const float nx = -x;
  if (nx > 20.f) return 1.f;
  const float z = expf(nx);
  return z / (z + 1.f);
}

// torch.maximum(a, b)'s share of the gradient to a
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// J columns of hd_v a lane (hd_v <= 32 J)
template <int J>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_scan_bwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ ig,
                          const float* __restrict__ fg,
                          const float* __restrict__ m0,
                          const float* __restrict__ Cck,
                          const float* __restrict__ nck,
                          const float* __restrict__ ms,
                          const float* __restrict__ qns,
                          const float* __restrict__ hs,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dC_in,
                          const float* __restrict__ dn_in,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dC0, float* __restrict__ dn0,
                          float* __restrict__ dvp, float* __restrict__ gp,
                          float* __restrict__ scratch, int S, int H,
                          int hd_k, int hd_v, int L) {
  __shared__ float red[2][kWarps][kRedW];
  __shared__ float nsm[kMaxL + 1][kRows];
  const int cb = blockIdx.x, n_blk = gridDim.x;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wrow = warp * kRW;                 // this warp's first local row
  const int rbase = cb * kRows + wrow;         // ... and its row of C
  const long long slot_sz = (long long)kRows * hd_v;
  float* scr =
      scratch + ((long long)bh * n_blk + cb) * (L + 1) * slot_sz;
  const long long rows_all = (long long)BH * S;   // (b, t, h) rows
  const long long gstride = 2 * n_blk + 1;

  float dC[kRW][J], dn[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int kr = rbase + r;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      dC[r][j] = (kr < hd_k && c < hd_v)
                     ? dC_in[((long long)bh * hd_k + kr) * hd_v + c] : 0.f;
    }
    dn[r] = kr < hd_k ? dn_in[(long long)bh * hd_k + kr] : 0.f;
  }
  int par = 0;
  const int n_seg = (S + L - 1) / L;
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    const int t0 = seg * L, t1 = min(S, t0 + L);
    // the segment's C and n from its checkpoint, as the forward made them
    {
      float C[kRW][J], n[kRW];
      const long long ck = (long long)seg * BH + bh;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int kr = rbase + r;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          const bool ok = kr < hd_k && c < hd_v;
          C[r][j] = ok ? Cck[(ck * hd_k + kr) * hd_v + c] : 0.f;
          if (ok) scr[(long long)(wrow + r) * hd_v + c] = C[r][j];
        }
        n[r] = kr < hd_k ? nck[ck * hd_k + kr] : 0.f;
        if (lane == 0) nsm[0][wrow + r] = n[r];
      }
      float m_p = t0 ? ms[((long long)b * S + t0 - 1) * H + h] : m0[bh];
      for (int t = t0; t < t1; ++t) {
        const long long row = ((long long)b * S + t) * H + h;
        const float m_t = ms[row];
        const float lfm = __fadd_rn(log_sigmoid(fg[row]), m_p);
        const float i_g = expf(__fsub_rn(ig[row], m_t));
        const float f_g = expf(__fsub_rn(lfm, m_t));
        float vv[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          vv[j] = c < hd_v ? v[row * hd_v + c] : 0.f;
        }
        float* slot = scr + (long long)(t - t0 + 1) * slot_sz;
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const int kr = rbase + r;
          if (kr < hd_k) {                     // warp-uniform
            const float kk = k[row * hd_k + kr];
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const int c = lane + 32 * j;
              if (c < hd_v) {
                const float kv = __fmul_rn(kk, vv[j]);
                C[r][j] = __fadd_rn(__fmul_rn(C[r][j], f_g),
                                    __fmul_rn(i_g, kv));
                slot[(long long)(wrow + r) * hd_v + c] = C[r][j];
              }
            }
            n[r] = __fadd_rn(__fmul_rn(n[r], f_g), __fmul_rn(i_g, kk));
          }
          if (lane == 0) nsm[t - t0 + 1][wrow + r] = n[r];
        }
        m_p = m_t;
      }
    }
    __syncthreads();   // nsm written by lane 0, read by every lane
    // the segment in reverse
    for (int t = t1 - 1; t >= t0; --t) {
      const long long row = ((long long)b * S + t) * H + h;
      const float m_t = ms[row];
      const float m_p = t ? ms[row - H] : m0[bh];
      const float lfm = __fadd_rn(log_sigmoid(fg[row]), m_p);
      const float i_g = expf(__fsub_rn(ig[row], m_t));
      const float f_g = expf(__fsub_rn(lfm, m_t));
      const float qn = qns[row], e = expf(-m_t), aq = fabsf(qn);
      const float den = nan_max(aq, e);
      float dnum[J], vv[J], dvs[J];
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        const float dh = c < hd_v ? dhs[row * hd_v + c] : 0.f;
        const float hv = c < hd_v ? hs[row * hd_v + c] : 0.f;
        dot += dh * hv;
        dnum[j] = dh / den;
        vv[j] = c < hd_v ? v[row * hd_v + c] : 0.f;
        dvs[j] = 0.f;
      }
      const float dden = -warp_sum(dot) / den;
      const float w_q = max_share(aq, e);
      const float sg = qn > 0.f ? 1.f : (qn < 0.f ? -1.f : 0.f);
      const float dqn = dden * w_q * sg;
      const float* Ct = scr + (long long)(t - t0 + 1) * slot_sz;
      const float* Cp = scr + (long long)(t - t0) * slot_sz;
      float dig_w = 0.f, dfg_p = 0.f;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int kr = rbase + r;
        if (kr < hd_k) {                       // warp-uniform
          const float qk = q[row * hd_k + kr], kk = k[row * hd_k + kr];
          const float* ct = Ct + (long long)(wrow + r) * hd_v;
          const float* cp = Cp + (long long)(wrow + r) * hd_v;
          float dqp = 0.f, dcv = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int c = lane + 32 * j;
            if (c < hd_v) {
              dC[r][j] += qk * dnum[j];
              dqp += ct[c] * dnum[j];
              dcv += dC[r][j] * vv[j];
              dfg_p += dC[r][j] * cp[c];
              dvs[j] += dC[r][j] * kk;
              dC[r][j] *= f_g;
            }
          }
          dn[r] += qk * dqn;
          dqp = warp_sum(dqp);
          dcv = warp_sum(dcv) + dn[r];
          if (lane == 0) {
            dq[row * hd_k + kr] = dqp + nsm[t - t0 + 1][wrow + r] * dqn;
            dk[row * hd_k + kr] = i_g * dcv;
            dfg_p += dn[r] * nsm[t - t0][wrow + r];
          }
          dig_w += kk * dcv;
          dn[r] *= f_g;
        }
      }
      const float dfg_w = warp_sum(dfg_p);
      float* rw = red[par][warp];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < hd_v) rw[c] = dvs[j];
      }
      if (lane == 0) {
        rw[kMaxHdV] = dig_w;
        rw[kMaxHdV + 1] = dfg_w;
      }
      __syncthreads();
      // one thread a sum over the warps, in order (the other buffer is
      // the next step's: no second barrier)
      for (int c = tid; c < hd_v; c += kThreads) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[par][w][c];
        dvp[((long long)cb * rows_all + row) * hd_v + c] = i_g * acc;
      }
      if (tid == kThreads - 1) {
        float dig_b = 0.f, dfg_b = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          dig_b += red[par][w][kMaxHdV];
          dfg_b += red[par][w][kMaxHdV + 1];
        }
        float* g = gp + ((long long)bh * S + t) * gstride;
        g[cb] = dig_b;
        g[n_blk + cb] = dfg_b;
        if (cb == 0) g[2 * n_blk] = -e * (dden * (1.f - w_q));
      }
      par ^= 1;
    }
  }
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int kr = rbase + r;
    if (kr < hd_k) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < hd_v) dC0[((long long)bh * hd_k + kr) * hd_v + c] = dC[r][j];
      }
      if (lane == 0) dn0[(long long)bh * hd_k + kr] = dn[r];
    }
  }
}

// Blocks [0, B H): the stabilizer's scalar chain of one (b, h), t from the
// last step, from the partials' sums over the row blocks (in order): di,
// df (B, S, H) and dm0 (B, H), from dm_in, the final m's cotangent.
// Blocks from B H: dv = the sum over the row blocks of dvp, in order.
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_bwd_reduce(const float* __restrict__ gp,
                          const float* __restrict__ ig,
                          const float* __restrict__ fg,
                          const float* __restrict__ ms,
                          const float* __restrict__ m0,
                          const float* __restrict__ dm_in,
                          const float* __restrict__ dvp,
                          float* __restrict__ di, float* __restrict__ df,
                          float* __restrict__ dm0, float* __restrict__ dv,
                          int S, int H, int hd_v, int n_blk, int BH) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= BH) {
    const long long N = (long long)BH * S * hd_v;
    const long long stride = (long long)(gridDim.x - BH) * blockDim.x;
    for (long long i = (long long)(blockIdx.x - BH) * blockDim.x + tid; i < N;
         i += stride) {
      float acc = 0.f;
      for (int c = 0; c < n_blk; ++c) acc += dvp[(long long)c * N + i];
      dv[i] = acc;
    }
    return;
  }
  __shared__ float sums[kChunk][3];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const long long gstride = 2 * n_blk + 1;
  float dm = dm_in[bh];
  for (int hi = S; hi > 0; hi -= kChunk) {
    const int lo = max(0, hi - kChunk);
    for (int t = lo + tid; t < hi; t += blockDim.x) {
      const float* g = gp + ((long long)bh * S + t) * gstride;
      float dig = 0.f, dfg = 0.f;
      for (int c = 0; c < n_blk; ++c) {
        dig += g[c];
        dfg += g[n_blk + c];
      }
      sums[t - lo][0] = dig;
      sums[t - lo][1] = dfg;
      sums[t - lo][2] = g[2 * n_blk];
    }
    __syncthreads();
    if (tid == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        const long long row = ((long long)b * S + t) * H + h;
        const float m_t = ms[row];
        const float m_p = t ? ms[row - H] : m0[bh];
        const float ipre = ig[row], fpre = fg[row];
        const float lfm = __fadd_rn(log_sigmoid(fpre), m_p);
        const float i_g = expf(__fsub_rn(ipre, m_t));
        const float f_g = expf(__fsub_rn(lfm, m_t));
        dm += sums[t - lo][2];
        const float d_i = sums[t - lo][0] * i_g;
        float d_a = sums[t - lo][1] * f_g;
        dm = dm - d_i - d_a;
        const float w_a = max_share(lfm, ipre);
        d_a += dm * w_a;
        di[row] = d_i + dm * (1.f - w_a);
        df[row] = d_a * dlog_sigmoid(fpre);
        dm = d_a;
      }
    }
    __syncthreads();
  }
  if (tid == 0) dm0[bh] = dm;
}

#define MLSTM_BWD(J) \
  {(const void*)mlstm_scan_bwd_kernel<J>, "mlstm_scan_bwd_kernel<" #J ">"}

const repro::KernelSlot kSlots[] = {
    MLSTM_BWD(1), MLSTM_BWD(2), MLSTM_BWD(4), MLSTM_BWD(8), MLSTM_BWD(16),
    {(const void*)mlstm_scan_bwd_reduce, "mlstm_scan_bwd_reduce"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

const void* kernel_of(int hd_v) {
  if (hd_v <= 32) return (const void*)mlstm_scan_bwd_kernel<1>;
  if (hd_v <= 64) return (const void*)mlstm_scan_bwd_kernel<2>;
  if (hd_v <= 128) return (const void*)mlstm_scan_bwd_kernel<4>;
  if (hd_v <= 256) return (const void*)mlstm_scan_bwd_kernel<8>;
  if (hd_v <= 512) return (const void*)mlstm_scan_bwd_kernel<16>;
  return nullptr;
}

}  // namespace

// The gradients of the scan (repro_mlstm_scan) of q, k (B, S, H, hd_k), v
// (B, S, H, hd_v), i and f (B, S, H) from m0 (B, H): dq, dk, dv, di, df,
// dC0, dn0, dm0, from its training mode's Cck, nck, ms, qns (checkpoints
// every L steps), its output hs and the cotangents dhs, dC, dn, dm of hs
// and of the final state.  dvp (ceil(hd_k / 32), B, S, H, hd_v), gp (B H,
// S, 2 ceil(hd_k / 32) + 1) and scratch (B H ceil(hd_k / 32), L + 1, 32
// hd_v) are the caller's work buffers.
extern "C" int repro_mlstm_scan_bwd(
    const float* q, const float* k, const float* v, const float* ig,
    const float* fg, const float* m0, const float* Cck, const float* nck,
    const float* ms, const float* qns, const float* hs, const float* dhs,
    const float* dC, const float* dn, const float* dm, float* dq, float* dk,
    float* dv, float* di, float* df, float* dC0, float* dn0, float* dm0,
    float* dvp, float* gp, float* scratch, int B, int S, int H, int hd_k,
    int hd_v, int L, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd_k < 1 || hd_v < 1 || L < 1 ||
      L > kMaxL || hd_v > kMaxHdV)
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(hd_v);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = repro::note_launch(kSlots, kMax, fn, 0, kThreads);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_blk = (hd_k + kRows - 1) / kRows, BH = B * H;
  void* args[] = {&q,   &k,   &v,   &ig,  &fg,  &m0,  &Cck, &nck, &ms,
                  &qns, &hs,  &dhs, &dC,  &dn,  &dq,  &dk,  &dC0, &dn0,
                  &dvp, &gp,  &scratch, &S, &H, &hd_k, &hd_v, &L};
  err = cudaLaunchKernel(fn, dim3(n_blk, BH), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const void* red = (const void*)mlstm_scan_bwd_reduce;
  if ((err = repro::note_launch(kSlots, kMax, red, 0, kThreads)) !=
      cudaSuccess)
    return (int)err;
  const long long N = (long long)BH * S * hd_v;
  const int dv_blocks =
      (int)std::min<long long>(1024, (N + kThreads - 1) / kThreads);
  void* rargs[] = {&gp, &ig, &fg, &ms,  &m0,   &dm,   &dvp, &di,
                   &df, &dm0, &dv, &S,  &H,    &hd_v, &n_blk, &BH};
  err = cudaLaunchKernel(red, dim3(BH + dv_blocks), dim3(kThreads), rargs, 0,
                         st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(mlstm_scan_bwd)
