// K2 cd_tile_solve: the exact sequential coordinate-descent chain over the
// T coordinates of a feature tile, one tile or many tiles a launch.
//
// Replaces src/repro/kernels/cd_tile_solve.py::cd_tile_solve_pallas (TPU
// Pallas).  For j = 0 .. T-1 in order:
//   num = g_j + mu h_j (beta_j + d_j) + nu beta_j
//   u   = S(num, lam1 pf_j) / max(den_j, 1e-30),  den = mu h + nu + lam2 pf
//   u   = beta_j where den_j <= 0          (dead column: step stays 0)
//   delta = (u - beta_j) - d_j;  d_j = u - beta_j;  g -= mu delta G[:, j]
//
// Bound on the card: the dependency chain.  The work is T (T - 1) / 2
// multiply-adds and one read of G (256 KiB at T = 256), microseconds for
// the card's rates, but each step needs the one before it, so a tile takes
// at least T times the latency of one step's dependent instructions.  The
// TPU kernel pinned G in VMEM and ran a scalar loop; here the chain runs
// in warp-wide panels of 32 coordinates with deferred, in-order updates
// between panels (cd_chain.cuh), bit-exact with the plain version.
// chip_smoke.py measures that floor with tools/chain_floor.cu.
//
// One block per tile.  Gauss-Seidel couples the tiles through the margins,
// so it launches one tile at a time; a Jacobi sweep launches every tile at
// once (one block per live tile, dead tiles write 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_chain.cuh"
#include "resources.cuh"

namespace {

template <int kBlock>
__global__ void __launch_bounds__(kBlock)
    cd_tile_solve_kernel(const float* __restrict__ G,
                         const float* __restrict__ g,
                         const float* __restrict__ h, long long hs,
                         const float* __restrict__ beta,
                         const float* __restrict__ dbeta,
                         const float* __restrict__ penf,
                         const float* __restrict__ params,
                         const int* __restrict__ order, int n_live, int T,
                         bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  repro::cd_chain_tiles(G, g, h, hs, beta, dbeta, penf, params, order,
                        n_live, T, vec, out, smem);
}

const repro::KernelSlot kSlots[] = {
    {(const void*)cd_tile_solve_kernel<512>, "cd_tile_solve_kernel<512>"},
    {(const void*)cd_tile_solve_kernel<1024>, "cd_tile_solve_kernel<1024>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

cudaError_t note(const void* fn, size_t smem, int threads) {
  return repro::note_launch(kSlots, kMax, fn, smem, threads);
}

}  // namespace

// G (nt, T, T), g, beta, penf, out (nt * T), T <= 1024; params: device
// (4,) f32 [mu, nu, lam1, lam2].  Block z solves tile order[z] (tile z when
// order is null); blocks z >= n_live write a zero step.  h: null (read
// from G's diagonal) or, when nt == 1, any (T,) vector with element stride
// hs; dbeta: the entering step, null for zero; penf: null for all ones.
extern "C" int repro_cd_tile_solve(const float* G, const float* g,
                                   const float* h, long long hs,
                                   const float* beta, const float* dbeta,
                                   const float* penf, const float* params,
                                   const int* order, int n_live, int nt,
                                   int T, float* out, void* stream) {
  if (T <= 0 || T > repro::chain::kMaxT || nt <= 0 || n_live < 0 ||
      n_live > nt || (h != nullptr && nt != 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0;
  return (int)repro::launch_chain(
      cd_tile_solve_kernel<512>, cd_tile_solve_kernel<1024>, nt, T,
      static_cast<cudaStream_t>(stream), note, G, g, h, hs, beta, dbeta,
      penf, params, order, n_live, T, vec, out);
}

REPRO_RESOURCES_ENTRY(cd_tile_solve)
