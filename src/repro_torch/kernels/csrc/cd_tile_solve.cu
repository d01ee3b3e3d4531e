// K2 cd_tile_solve: the exact sequential coordinate-descent chain over the
// T coordinates of one feature tile.
//
// Replaces src/repro/kernels/cd_tile_solve.py::cd_tile_solve_pallas (TPU
// Pallas).  For j = 0 .. T-1 in order:
//   num = g_j + mu h_j (beta_j + d_j) + nu beta_j
//   u   = S(num, lam1 pf_j) / max(den_j, 1e-30),  den = mu h + nu + lam2 pf
//   u   = beta_j where den_j <= 0          (dead column: step stays 0)
//   delta = (u - beta_j) - d_j;  d_j = u - beta_j;  g -= mu delta G[:, j]
//
// Bound on the card: latency.  The work is T^2 multiply-adds (65,536 at
// T = 256) and one read of G (256 KiB), microseconds for the card's rates,
// but every step depends on the one before it.  The fp32 G of one tile does
// not fit in the 227 KB of shared memory a block may hold, so it stays in
// global memory.  Design: one block of T threads; thread k owns g_k and d_k
// in registers.  At step j thread j forms the update and writes its delta to
// shared slot j; one __syncthreads() later every thread k applies
// g_k -= mu delta G[k, j].  Thread k reads row k of G left to right over the
// chain, so each 128-byte line it touches serves 32 steps from L1; the loads
// do not depend on the chain and are issued ahead of the barrier.  Each slot
// is written once, so one barrier per step suffices.  The arithmetic is
// rounded step by step (no fused multiply-add) in the order of the plain
// version, so the kernel reproduces it bit for bit on the same inputs.
// Gauss-Seidel couples the tiles through the margins, so there is one launch
// per tile.
#include <cuda_runtime.h>

namespace {

__global__ void cd_tile_solve_kernel(const float* __restrict__ G,
                                     const float* __restrict__ g,
                                     const float* __restrict__ h,
                                     const float* __restrict__ beta,
                                     const float* __restrict__ dbeta,
                                     const float* __restrict__ penf,
                                     const float* __restrict__ params,
                                     float* __restrict__ out, int T) {
  extern __shared__ float delta_s[];
  const int k = threadIdx.x;
  const float mu = params[0];
  const float nu = params[1];
  const float lam1 = params[2];
  const float lam2 = params[3];
  float gk = g[k];
  float dk = dbeta[k];
  const float bk = beta[k];
  const float hk = h[k];
  const float l1 = __fmul_rn(lam1, penf[k]);
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(mu, hk), nu),
                              __fmul_rn(lam2, penf[k]));
  const float den_safe = fmaxf(den, 1e-30f);
  const float muhk = __fmul_rn(mu, hk);
  const float* Grow = G + (long long)k * T;
  for (int j = 0; j < T; ++j) {
    const float Gkj = __ldg(Grow + j);
    if (k == j) {
      float num = __fadd_rn(__fadd_rn(gk, __fmul_rn(muhk, __fadd_rn(bk, dk))),
                            __fmul_rn(nu, bk));
      float mag = fmaxf(__fsub_rn(fabsf(num), l1), 0.f);
      float sgn = num > 0.f ? 1.f : (num < 0.f ? -1.f : 0.f);
      float u = __fdiv_rn(__fmul_rn(sgn, mag), den_safe);
      if (!(den > 0.f)) u = bk;
      float dnew = __fsub_rn(u, bk);
      delta_s[j] = __fsub_rn(dnew, dk);
      dk = dnew;
    }
    __syncthreads();
    gk = __fsub_rn(gk, __fmul_rn(__fmul_rn(mu, delta_s[j]), Gkj));
  }
  out[k] = dk;
}

}  // namespace

// params: device (4,) f32 [mu, nu, lam1, lam2].  T <= 1024.
extern "C" int repro_cd_tile_solve(const float* G, const float* g,
                                   const float* h, const float* beta,
                                   const float* dbeta, const float* penf,
                                   const float* params, float* out, int T,
                                   void* stream) {
  if (T <= 0 || T > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cd_tile_solve_kernel<<<1, T, T * sizeof(float), st>>>(G, g, h, beta, dbeta,
                                                        penf, params, out, T);
  return (int)cudaGetLastError();
}
