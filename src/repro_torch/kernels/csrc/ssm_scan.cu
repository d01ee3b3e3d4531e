// Mamba2's selective scan over a whole sequence, every (batch row, head)
// in one launch.
//
// Replaces no Pallas kernel: it is the port of the reference's
// src/repro/models/ssm.py::_ssm_scan (:48-63), a lax.scan over time that
// XLA compiles into one loop (a Python loop costs about ten launches a
// step).  For each (b, h), with the (hd, ds) state h and t in order:
//   decay = exp(-dt_t A_h);   h = h decay + (x_t dt_t) B_t
//   y_t   = h C_t + D_h x_t
// Decode is the same kernel at S = 1, from the cache's state.
//
// Bound on the card: the bytes are x and y once (B S H hd floats each), B,
// C and dt, and the state twice: about 47 MB at zamba2's prefill (B 2, S
// 704, H 64, hd 64, ds 64), 0.014 ms at 3.35 TB/s.  But each (b, h) is a
// chain of S dependent steps, and only B H chains run: the time is the
// chain's.  Design: one block of 256 threads a (b, h), its state in
// registers for the whole sequence: warp w holds the rows p = w + 8 r,
// lane l the columns s = l + 32 j.  The state's own chain is a product and
// a sum a step; y_t's sum over ds (warp shuffles) hangs off it.  The next
// step's x, dt, B and C are loaded while this step computes.  The update
// is rounded as the plain version's (products and sums apart: no fused
// multiply-add); y's sum over ds is a float32 sum in another order.
// Training mode (ckpt not null): the state before every L-th step is
// also written, (ceil(S / L), B, H, hd, ds), for ssm_scan_bwd.cu; serving
// passes null and writes nothing more.
#include <cuda_runtime.h>
#include <math.h>

#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RPW rows a warp (hd <= 8 RPW), SPL columns a lane (ds <= 32 SPL)
template <int RPW, int SPL>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ D,
                    const float* s_in, float* __restrict__ y, float* s_out,
                    float* __restrict__ ckpt, int S, int H, int hd, int ds,
                    int L) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sbase = (long long)bh * hd * ds;

  float st[RPW][SPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = warp + kWarps * r;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane + 32 * j;
      st[r][j] = (p < hd && s < ds) ? s_in[sbase + (long long)p * ds + s] : 0.f;
    }
  }
  const float a = A[h], dd = D[h];

  // step t's inputs: x (B, S, H, hd), B and C (B, S, ds), dt (B, S, H)
  float xn[RPW], bn[SPL], cn[SPL], dtn;
  auto load = [&](int t) {
    const long long row = (long long)b * S + t;
    const float* xt = x + (row * H + h) * hd;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int p = warp + kWarps * r;
      xn[r] = p < hd ? xt[p] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane + 32 * j;
      bn[j] = s < ds ? Bm[row * ds + s] : 0.f;
      cn[j] = s < ds ? Cm[row * ds + s] : 0.f;
    }
    dtn = dt[row * H + h];
  };
  load(0);
  for (int t = 0; t < S; ++t) {
    float xc[RPW], bc[SPL], cc[SPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) xc[r] = xn[r];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      bc[j] = bn[j];
      cc[j] = cn[j];
    }
    const float dtc = dtn;
    if (t + 1 < S) load(t + 1);
    if (ckpt != nullptr && t % L == 0) {
      float* ck = ckpt + ((long long)(t / L) * gridDim.x) * hd * ds + sbase;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int p = warp + kWarps * r;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (p < hd && s < ds) ck[(long long)p * ds + s] = st[r][j];
        }
      }
    }
    const float decay = expf(__fmul_rn(-dtc, a));
    float* yt = y + (((long long)b * S + t) * H + h) * hd;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int p = warp + kWarps * r;
      if (p < hd) {                       // warp-uniform
        const float xdt = __fmul_rn(xc[r], dtc);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const float upd = __fmul_rn(xdt, bc[j]);
          st[r][j] = __fadd_rn(__fmul_rn(st[r][j], decay), upd);
          part = fmaf(st[r][j], cc[j], part);
        }
        part = warp_sum(part);
        if (lane == 0) yt[p] = __fadd_rn(part, __fmul_rn(dd, xc[r]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = warp + kWarps * r;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane + 32 * j;
      if (p < hd && s < ds) s_out[sbase + (long long)p * ds + s] = st[r][j];
    }
  }
}

#define SSM_SCAN(R, J) \
  {(const void*)ssm_scan_kernel<R, J>, "ssm_scan_kernel<" #R "," #J ">"}

const repro::KernelSlot kSlots[] = {
    SSM_SCAN(1, 1), SSM_SCAN(1, 2), SSM_SCAN(1, 4),
    SSM_SCAN(2, 1), SSM_SCAN(2, 2), SSM_SCAN(2, 4),
    SSM_SCAN(4, 1), SSM_SCAN(4, 2), SSM_SCAN(4, 4),
    SSM_SCAN(8, 1), SSM_SCAN(8, 2), SSM_SCAN(8, 4),
    SSM_SCAN(16, 1), SSM_SCAN(16, 2), SSM_SCAN(16, 4),
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

template <int R>
const void* kernel_for(int spl) {
  switch (spl) {
    case 1: return (const void*)ssm_scan_kernel<R, 1>;
    case 2: return (const void*)ssm_scan_kernel<R, 2>;
    case 4: return (const void*)ssm_scan_kernel<R, 4>;
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

// y (B, S, H, hd) and s_out (B, H, hd, ds): the scan of x (B, S, H, hd),
// Bm and Cm (B, S, ds), dt (B, S, H), A and D (H,) from s_in (B, H, hd,
// ds).  s_out may be s_in (each block reads its state before it writes).
// ckpt: null, or (ceil(S / L), B, H, hd, ds) for the states before steps
// 0, L, 2L, ...
extern "C" int repro_ssm_scan(const float* x, const float* Bm, const float* Cm,
                              const float* dt, const float* A, const float* D,
                              const float* s_in, float* y, float* s_out,
                              float* ckpt, int B, int S, int H, int hd, int ds,
                              int L, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || ds < 1 || hd > 16 * kWarps ||
      ds > 128 || (ckpt != nullptr && L < 1))
    return (int)cudaErrorInvalidValue;
  const int rpw = pow2_at_least((hd + kWarps - 1) / kWarps);
  const int spl = pow2_at_least((ds + 31) / 32);
  const void* fn = kernel_of(rpw, spl);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = repro::note_launch(kSlots, kMax, fn, 0, kThreads);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &Bm, &Cm, &dt, &A, &D, &s_in, &y, &s_out,
                  &ckpt, &S, &H, &hd, &ds, &L};
  err = cudaLaunchKernel(fn, dim3(B * H), dim3(kThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_RESOURCES_ENTRY(ssm_scan)
