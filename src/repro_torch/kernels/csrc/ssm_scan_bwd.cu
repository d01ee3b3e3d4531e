// The backward of Mamba2's selective scan: every (batch row, head) in one
// launch, its time steps in reverse.
//
// Replaces no Pallas kernel: it is the transpose of the reference's
// src/repro/models/ssm.py::_ssm_scan (:48-63), the reverse-time loop XLA
// compiles for jax.vjp of its lax.scan.  For each (b, h), with G = dL/dh_t
// (hd, ds) and t from the last step:
//   G += dy_t C_t^T;   dC_t += h_t^T dy_t;   dD += dy_t . x_t
//   dxdt = G B_t;   dB_t += G^T (x_t dt_t);   dx_t = dxdt dt_t + D dy_t
//   du = <G, h_{t-1}> decay_t;   ddt_t = dxdt . x_t - du A;   dA -= du dt_t
//   G *= decay_t   (decay_t = exp(-dt_t A))
// and dstate0 = G at the end.  The states come from the forward's training
// mode, the state before every L-th step (ssm_scan.cu): a segment's L
// states are recomputed from its checkpoint with the forward's own
// rounding (products and sums apart), the same bits, into this block's
// slots of a scratch buffer (each thread reads back only what it wrote),
// then the segment runs in reverse.  No step divides by the decay: it
// underflows to 0 at large dt A.
//
// Bound on the card: like the forward, each (b, h) is a chain of S
// dependent steps, and only B H chains run.  The bytes are the forward's
// inputs, dy, the checkpoints (1/L of the states), the gradients, and the
// recomputed states written and read back once (35 MB at zamba2's B 2, H
// 64, hd 64, ds 64 and L 16: inside the L2).  Design: the forward's block
// of 256 threads a (b, h), the state and G in registers (warp w the rows
// p = w + 8 r, lane l the columns s = l + 32 j).  Sums over the columns
// (dxdt) are warp shuffles; sums over the rows (dB, dC, and the scalars
// du, ddt, dD) are each warp's partial in shared memory, double-buffered
// by step, summed over the 8 warps in order by one thread each.  dB and dC
// are shared by the H heads and A and D by the B rows: each block writes
// its partials, and ssm_scan_bwd_reduce sums them in a fixed order.  No
// float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDs = 128;
constexpr int kRed = 2 * kMaxDs + 3;     // dC, dB, then du, ddt, dD

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RPW rows a warp (hd <= 8 RPW), SPL columns a lane (ds <= 32 SPL)
template <int RPW, int SPL>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ D,
                        const float* __restrict__ ckpt,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh, float* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ ds0,
                        float* __restrict__ dBp, float* __restrict__ dCp,
                        float* __restrict__ dADp, float* __restrict__ scratch,
                        int S, int H, int hd, int ds, int L) {
  __shared__ float red[2][kWarps][kRed];
  const int bh = blockIdx.x, BH = gridDim.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long hdds = (long long)hd * ds;
  const long long sbase = (long long)bh * hdds;
  float* scr = scratch + (long long)bh * (L + 1) * hdds;
  const float a = A[h], dd = D[h];

  float G[RPW][SPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = warp + kWarps * r;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane + 32 * j;
      G[r][j] = (p < hd && s < ds) ? dh[sbase + (long long)p * ds + s] : 0.f;
    }
  }
  float dA_acc = 0.f, dD_acc = 0.f;   // thread 0's, over this block's steps
  int par = 0;
  const int n_seg = (S + L - 1) / L;
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    const int t0 = seg * L, t1 = min(S, t0 + L);
    // the segment's states from its checkpoint, as the forward made them
    {
      float st[RPW][SPL];
      const float* ck = ckpt + ((long long)seg * BH + bh) * hdds;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int p = warp + kWarps * r;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          const long long e = (long long)p * ds + s;
          st[r][j] = (p < hd && s < ds) ? ck[e] : 0.f;
          if (p < hd && s < ds) scr[e] = st[r][j];
        }
      }
      for (int t = t0; t < t1; ++t) {
        const long long row = (long long)b * S + t;
        const float dtc = dt[row * H + h];
        const float decay = expf(__fmul_rn(-dtc, a));
        const float* xt = x + (row * H + h) * hd;
        float* slot = scr + (long long)(t - t0 + 1) * hdds;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int p = warp + kWarps * r;
          if (p < hd) {                     // warp-uniform
            const float xdt = __fmul_rn(xt[p], dtc);
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              const int s = lane + 32 * j;
              if (s < ds) {
                const float upd = __fmul_rn(xdt, Bm[row * ds + s]);
                st[r][j] = __fadd_rn(__fmul_rn(st[r][j], decay), upd);
                slot[(long long)p * ds + s] = st[r][j];
              }
            }
          }
        }
      }
    }
    // the segment in reverse
    for (int t = t1 - 1; t >= t0; --t) {
      const long long row = (long long)b * S + t;
      const float dtc = dt[row * H + h];
      const float decay = expf(__fmul_rn(-dtc, a));
      const float* xt = x + (row * H + h) * hd;
      const float* dyt = dy + (row * H + h) * hd;
      const float* h_t = scr + (long long)(t - t0 + 1) * hdds;
      const float* h_p = scr + (long long)(t - t0) * hdds;
      float bc[SPL], cc[SPL], dCs[SPL], dBs[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = lane + 32 * j;
        bc[j] = s < ds ? Bm[row * ds + s] : 0.f;
        cc[j] = s < ds ? Cm[row * ds + s] : 0.f;
        dCs[j] = 0.f;
        dBs[j] = 0.f;
      }
      float du = 0.f, ddt_w = 0.f, dD_w = 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int p = warp + kWarps * r;
        if (p < hd) {                       // warp-uniform
          const float xv = xt[p], dyv = dyt[p];
          const float xdt = __fmul_rn(xv, dtc);
          float dxdt = 0.f;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            if (s < ds) {
              const long long e = (long long)p * ds + s;
              G[r][j] += dyv * cc[j];
              dCs[j] += h_t[e] * dyv;
              dBs[j] += G[r][j] * xdt;
              dxdt += G[r][j] * bc[j];
              du += G[r][j] * h_p[e];
              G[r][j] *= decay;
            }
          }
          dxdt = warp_sum(dxdt);
          if (lane == 0) dx[(row * H + h) * hd + p] = dxdt * dtc + dd * dyv;
          ddt_w += dxdt * xv;
          dD_w += dyv * xv;
        }
      }
      du = warp_sum(du);
      float* rw = red[par][warp];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = lane + 32 * j;
        if (s < ds) {
          rw[s] = dCs[j];
          rw[kMaxDs + s] = dBs[j];
        }
      }
      if (lane == 0) {
        rw[2 * kMaxDs] = du;
        rw[2 * kMaxDs + 1] = ddt_w;
        rw[2 * kMaxDs + 2] = dD_w;
      }
      __syncthreads();
      // one thread a sum over the warps, in order (the other buffer is
      // the next step's: no second barrier)
      const long long pb = (row * H + h) * ds;
      if (tid < ds) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[par][w][tid];
        dCp[pb + tid] = acc;
      } else if (tid >= kMaxDs && tid < kMaxDs + ds) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[par][w][tid];
        dBp[pb + tid - kMaxDs] = acc;
      }
      if (tid == kThreads - 1) {
        float du_b = 0.f, ddt_b = 0.f, dD_b = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          du_b += red[par][w][2 * kMaxDs];
          ddt_b += red[par][w][2 * kMaxDs + 1];
          dD_b += red[par][w][2 * kMaxDs + 2];
        }
        du_b *= decay;
        ddt[row * H + h] = ddt_b - du_b * a;
        dA_acc -= du_b * dtc;
        dD_acc += dD_b;
      }
      par ^= 1;
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = warp + kWarps * r;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane + 32 * j;
      if (p < hd && s < ds) ds0[sbase + (long long)p * ds + s] = G[r][j];
    }
  }
  if (tid == kThreads - 1) {
    dADp[bh] = dA_acc;
    dADp[BH + bh] = dD_acc;
  }
}

// dBm, dCm (B S, ds) = the sums over the H heads of dBp, dCp (B S, H, ds);
// dA, dD (H,) = the sums over the B rows of dADp (2, B, H); each in order.
__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_reduce(const float* __restrict__ dBp,
                        const float* __restrict__ dCp,
                        const float* __restrict__ dADp, float* __restrict__ dBm,
                        float* __restrict__ dCm, float* __restrict__ dA,
                        float* __restrict__ dD, int B, int S, int H, int ds) {
  const long long n1 = (long long)B * S * ds;
  const long long total = 2 * n1 + 2LL * H;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < 2 * n1) {
      const bool is_c = i >= n1;
      const long long e = is_c ? i - n1 : i;
      const long long row = e / ds, s = e - row * ds;
      const float* src = (is_c ? dCp : dBp) + row * H * ds + s;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc += src[(long long)hh * ds];
      (is_c ? dCm : dBm)[e] = acc;
    } else {
      const int j = (int)(i - 2 * n1), which = j / H, hh = j - which * H;
      const float* src = dADp + (long long)which * B * H + hh;
      float acc = 0.f;
      for (int bb = 0; bb < B; ++bb) acc += src[(long long)bb * H];
      (which == 0 ? dA : dD)[hh] = acc;
    }
  }
}

#define SSM_BWD(R, J)                          \
  {(const void*)ssm_scan_bwd_kernel<R, J>,     \
   "ssm_scan_bwd_kernel<" #R "," #J ">"}

const repro::KernelSlot kSlots[] = {
    SSM_BWD(1, 1), SSM_BWD(1, 2), SSM_BWD(1, 4),
    SSM_BWD(2, 1), SSM_BWD(2, 2), SSM_BWD(2, 4),
    SSM_BWD(4, 1), SSM_BWD(4, 2), SSM_BWD(4, 4),
    SSM_BWD(8, 1), SSM_BWD(8, 2), SSM_BWD(8, 4),
    SSM_BWD(16, 1), SSM_BWD(16, 2), SSM_BWD(16, 4),
    {(const void*)ssm_scan_bwd_reduce, "ssm_scan_bwd_reduce"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

template <int R>
const void* kernel_for(int spl) {
  switch (spl) {
    case 1: return (const void*)ssm_scan_bwd_kernel<R, 1>;
    case 2: return (const void*)ssm_scan_bwd_kernel<R, 2>;
    case 4: return (const void*)ssm_scan_bwd_kernel<R, 4>;
    default: return nullptr;
  }
}

const void* kernel_of(int rpw, int spl) {
  switch (rpw) {
    case 1: return kernel_for<1>(spl);
    case 2: return kernel_for<2>(spl);
    case 4: return kernel_for<4>(spl);
    case 8: return kernel_for<8>(spl);
    case 16: return kernel_for<16>(spl);
    default: return nullptr;
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

// The gradients of the scan (repro_ssm_scan) of x (B, S, H, hd), Bm and Cm
// (B, S, ds), dt (B, S, H), A and D (H,): dx, dBm, dCm, ddt, dA, dD and
// ds0 (the initial state's), from its checkpoints ckpt (ceil(S / L), B, H,
// hd, ds) and the cotangents dy (B, S, H, hd) and dh (B, H, hd, ds).
// dBp, dCp (B, S, H, ds), dADp (2, B, H) and scratch (B H, L + 1, hd ds)
// are the caller's work buffers.
extern "C" int repro_ssm_scan_bwd(
    const float* x, const float* Bm, const float* Cm, const float* dt,
    const float* A, const float* D, const float* ckpt, const float* dy,
    const float* dh, float* dx, float* dBm, float* dCm, float* ddt, float* dA,
    float* dD, float* ds0, float* dBp, float* dCp, float* dADp,
    float* scratch, int B, int S, int H, int hd, int ds, int L,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || ds < 1 || L < 1 ||
      hd > 16 * kWarps || ds > kMaxDs)
    return (int)cudaErrorInvalidValue;
  const int rpw = pow2_at_least((hd + kWarps - 1) / kWarps);
  const int spl = pow2_at_least((ds + 31) / 32);
  const void* fn = kernel_of(rpw, spl);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = repro::note_launch(kSlots, kMax, fn, 0, kThreads);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&x,  &Bm,  &Cm,  &dt,  &A,   &D,    &ckpt,    &dy,
                  &dh, &dx,  &ddt, &ds0, &dBp, &dCp,  &dADp,    &scratch,
                  &S,  &H,   &hd,  &ds,  &L};
  err = cudaLaunchKernel(fn, dim3(B * H), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const void* red = (const void*)ssm_scan_bwd_reduce;
  if ((err = repro::note_launch(kSlots, kMax, red, 0, kThreads)) !=
      cudaSuccess)
    return (int)err;
  const long long total = 2LL * B * S * ds + 2LL * H;
  const int blocks = (int)std::min<long long>(1024, (total + kThreads - 1) /
                                                        kThreads);
  void* rargs[] = {&dBp, &dCp, &dADp, &dBm, &dCm, &dA, &dD,
                   &B,   &S,   &H,    &ds};
  err = cudaLaunchKernel(red, dim3(blocks), dim3(kThreads), rargs, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(ssm_scan_bwd)
