// The mLSTM step scan over a whole sequence, every (batch row, head) in
// one launch.
//
// Replaces no Pallas kernel: it is the port of the reference's
// src/repro/models/xlstm.py::_mlstm_core (:52-76), a lax.scan of
// _mlstm_step over time that XLA compiles into one loop (a Python loop
// costs about a dozen launches a step).  For each (b, h), with the matrix
// memory C (hd_k, hd_v), the normalizer n (hd_k,), the stabilizer m and t
// in order (k scaled by 1/sqrt(hd) by the caller):
//   log_f = -softplus(-f_t);  m' = max(log_f + m, i_t)
//   i_g = exp(i_t - m');      f_g = exp(log_f + m - m')
//   C = C f_g + i_g k_t v_t^T;  n = n f_g + i_g k_t
//   h_t = (q_t C) / max(|q_t . n|, exp(-m'))
// Decode is the same kernel at S = 1, from the cache's state.
//
// Bound on the card: operations, and the chain.  The memory's update and
// readout are 6 hd_k hd_v flops a step and (b, h): about 7.4 GFLOP for
// xlstm-1.3b's 704-token prefill (B 2, H 4, hd 512), 0.11 ms at 67 TFLOP/s;
// but each (b, h) is a chain of S dependent steps.  C is 1 MB a (b, h) at
// hd 512, more than one SM holds, and its columns are independent given
// the gates and q.n: so a (b, h) is split over blocks of 32 columns of v
// (16 blocks at hd_v 512), each keeping its (hd_k, 32) slice of C in
// registers (lane l the column, warp w the rows w + 8 r) and the whole n,
// and recomputing the gates, m and q.n redundantly.  hd_k need not equal
// hd_v: on a model axis past 1, q, k and n are whole and v and C this
// rank's block.  A step stages q and k in shared memory (double-buffered,
// loaded a step ahead), updates C and n and takes each thread's partial
// q C and q.n, and reduces them across the 8 warps (two barriers).  The
// updates are rounded as the plain version's (products and sums apart: no
// fused multiply-add); q C and q.n are float32 sums in another order.
// max propagates NaN, as torch.maximum does.
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // columns of v a block
constexpr int kMaxHdK = 512;
constexpr int kNPer = kMaxHdK / kThreads;  // entries of n a thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// torch.maximum: NaN if either is
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// -softplus(-x), torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float log_sigmoid(float x) {
  const float nx = -x;
  return -(nx > 20.f ? nx : log1pf(expf(nx)));
}

// RPT rows of C a thread (hd_k <= 8 RPT)
template <int RPT>
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ ig,
                      const float* __restrict__ fg, const float* C_in,
                      const float* __restrict__ n_in,
                      const float* __restrict__ m_in, float* __restrict__ hs,
                      float* C_out, float* __restrict__ n_out,
                      float* __restrict__ m_out, int S, int H, int hd_k,
                      int hd_v) {
  __shared__ float qk[2][2][kMaxHdK];      // q_t, k_t by step parity
  __shared__ float red_num[kWarps][kCols];
  __shared__ float red_qn[kWarps];
  const int cb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = cb * kCols + lane;
  const bool col_ok = col < hd_v;

  float Creg[RPT];
  const long long cbase = (long long)bh * hd_k * hd_v;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = warp + kWarps * r;
    Creg[r] = (row < hd_k && col_ok)
                  ? C_in[cbase + (long long)row * hd_v + col] : 0.f;
  }
  float nreg[kNPer];
#pragma unroll
  for (int j = 0; j < kNPer; ++j) {
    const int kk = tid + kThreads * j;
    nreg[j] = kk < hd_k ? n_in[(long long)bh * hd_k + kk] : 0.f;
  }
  float m = m_in[bh];

  // step t's inputs: q, k (B, S, H, hd_k), v (B, S, H, hd_v), gates (B, S, H)
  float qn_[kNPer], kn_[kNPer], vn, in_, fn_;
  auto load = [&](int t) {
    const long long row = ((long long)b * S + t) * H + h;
#pragma unroll
    for (int j = 0; j < kNPer; ++j) {
      const int kk = tid + kThreads * j;
      qn_[j] = kk < hd_k ? q[row * hd_k + kk] : 0.f;
      kn_[j] = kk < hd_k ? k[row * hd_k + kk] : 0.f;
    }
    vn = col_ok ? v[row * hd_v + col] : 0.f;
    in_ = ig[row];
    fn_ = fg[row];
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kNPer; ++j) {
      qk[buf][0][tid + kThreads * j] = qn_[j];
      qk[buf][1][tid + kThreads * j] = kn_[j];
    }
  };
  load(0);
  stage(0);
  for (int t = 0; t < S; ++t) {
    const float vv = vn, ipre = in_, fpre = fn_;
    if (t + 1 < S) load(t + 1);
    __syncthreads();   // q_t, k_t staged; last step's sums read
    const float* qs = qk[t & 1][0];
    const float* ks = qk[t & 1][1];
    const float log_f = log_sigmoid(fpre);
    const float lfm = __fadd_rn(log_f, m);
    const float m_new = nan_max(lfm, ipre);
    const float i_g = expf(__fsub_rn(ipre, m_new));
    const float f_g = expf(__fsub_rn(lfm, m_new));

    float num = 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = warp + kWarps * r;
      if (row < hd_k) {                    // warp-uniform
        const float kv = __fmul_rn(ks[row], vv);
        Creg[r] = __fadd_rn(__fmul_rn(Creg[r], f_g), __fmul_rn(i_g, kv));
        num = fmaf(qs[row], Creg[r], num);
      }
    }
    float qn = 0.f;
#pragma unroll
    for (int j = 0; j < kNPer; ++j) {
      const int kk = tid + kThreads * j;
      if (kk < hd_k) {
        nreg[j] = __fadd_rn(__fmul_rn(nreg[j], f_g), __fmul_rn(i_g, ks[kk]));
        qn = fmaf(qs[kk], nreg[j], qn);
      }
    }
    qn = warp_sum(qn);
    red_num[warp][lane] = num;
    if (lane == 0) red_qn[warp] = qn;
    if (t + 1 < S) stage((t + 1) & 1);
    __syncthreads();
    if (warp == 0) {
      float tot = 0.f, qn_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        tot += red_num[w][lane];
        qn_all += red_qn[w];
      }
      const float den = nan_max(fabsf(qn_all), expf(-m_new));
      if (col_ok)
        hs[(((long long)b * S + t) * H + h) * hd_v + col] = tot / den;
    }
    m = m_new;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = warp + kWarps * r;
    if (row < hd_k && col_ok) C_out[cbase + (long long)row * hd_v + col] = Creg[r];
  }
  if (cb == 0) {
#pragma unroll
    for (int j = 0; j < kNPer; ++j) {
      const int kk = tid + kThreads * j;
      if (kk < hd_k) n_out[(long long)bh * hd_k + kk] = nreg[j];
    }
    if (tid == 0) m_out[bh] = m;
  }
}

#define MLSTM_SCAN(R) \
  {(const void*)mlstm_scan_kernel<R>, "mlstm_scan_kernel<" #R ">"}

const repro::KernelSlot kSlots[] = {MLSTM_SCAN(4), MLSTM_SCAN(16),
                                    MLSTM_SCAN(64)};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

const void* kernel_of(int hd_k) {
  if (hd_k <= 4 * kWarps) return (const void*)mlstm_scan_kernel<4>;
  if (hd_k <= 16 * kWarps) return (const void*)mlstm_scan_kernel<16>;
  if (hd_k <= 64 * kWarps) return (const void*)mlstm_scan_kernel<64>;
  return nullptr;
}

}  // namespace

// hs (B, S, H, hd_v) and the final C_out (B, H, hd_k, hd_v), n_out (B, H,
// hd_k), m_out (B, H): the scan of q, k (B, S, H, hd_k), v (B, S, H, hd_v),
// i and f (B, S, H) from C_in, n_in, m_in.  C_out may be C_in (a block
// reads its columns before it writes them); n_out and m_out must not be
// n_in and m_in (every block reads them, one block writes them).
extern "C" int repro_mlstm_scan(const float* q, const float* k, const float* v,
                                const float* ig, const float* fg,
                                const float* C_in, const float* n_in,
                                const float* m_in, float* hs, float* C_out,
                                float* n_out, float* m_out, int B, int S,
                                int H, int hd_k, int hd_v, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd_k < 1 || hd_v < 1 || hd_k > kMaxHdK ||
      n_in == n_out || m_in == m_out)
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(hd_k);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = repro::note_launch(kSlots, kMax, fn, 0, kThreads);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q,    &k,     &v,     &ig, &fg, &C_in, &n_in, &m_in, &hs,
                  &C_out, &n_out, &m_out, &S, &H, &hd_k, &hd_v};
  const dim3 grid((hd_v + kCols - 1) / kCols, B * H);
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(mlstm_scan)
