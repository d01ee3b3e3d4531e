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
// global memory.  Design: one block of T threads running the chain of
// cd_chain.cuh (thread k owns g_k and d_k in registers, one barrier per
// step, rounded step by step so it matches the plain version bit for bit).
// Gauss-Seidel couples the tiles through the margins, so there is one launch
// per tile.
#include <cuda_runtime.h>

#include "cd_chain.cuh"

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
  out[k] = repro::cd_chain(G, g[k], h[k], beta[k], dbeta[k], penf[k],
                           params[0], params[1], params[2], params[3],
                           delta_s, T, k);
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
