// Latency probes of K2's coordinate chain (cd_chain.cuh), on no path of the
// package.  chip_smoke.py builds this file with nvcc and reports from it:
//
//  * chain_floor_minimal: the dependency floor of one step.  One thread runs
//    the step's dependent rounded operations as the plain version defines
//    them (kernels/ref.py::cd_tile_solve), each once, with everything that
//    does not depend on the chain made before it: the per-coordinate
//    constants sit in registers and the divisor's reciprocal is ready, so
//    the correctly rounded quotient is a multiply and two fused
//    multiply-adds (its range check runs off the chain, as in the kernel).
//    From g_j to g_{j+1}:
//      num = (g + a) + b;  mag = max(|num| - l1, 0);  q = mag / div;
//      d = sgn(num) q - beta;  md = mu (d - d_in);  g -= md G[j+1, j]
//    13 dependent operations; sgn(num) is off the chain.  No broadcast
//    between lanes is counted: a design may carry every g of a panel in
//    each lane.  Any bit-exact chain does at least this work in sequence.
//  * chain_floor_design: one step of the kernel's own panel loop (one warp
//    over the first 32 coordinates of a tile, shuffles included): this
//    design's step latency, not a floor.
//
// Each writes the SM cycles (clock64) and nanoseconds (%globaltimer) of its
// timed loop, so the clock the cycles ran at comes from the same run.
#include <cuda_runtime.h>

#include "cd_chain.cuh"

namespace {

constexpr int kSteps = 16;   // coordinates of the minimal probe's loop

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// c: (8 kSteps + 2) floats, the rows a, b, l1, div, rcp, beta, d_in and
// G[j+1, j] of kSteps coordinates, then mu and the entering g.
__global__ void __launch_bounds__(32)
    minimal_chain_kernel(const float* __restrict__ c, int reps,
                         long long* __restrict__ out,
                         float* __restrict__ sink) {
  if (threadIdx.x != 0) return;
  float a[kSteps], b[kSteps], l1[kSteps], dv[kSteps], rcp[kSteps],
      bt[kSteps], din[kSteps], gs[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    a[i] = c[i];
    b[i] = c[kSteps + i];
    l1[i] = c[2 * kSteps + i];
    dv[i] = c[3 * kSteps + i];
    rcp[i] = c[4 * kSteps + i];
    bt[i] = c[5 * kSteps + i];
    din[i] = c[6 * kSteps + i];
    gs[i] = c[7 * kSteps + i];
  }
  const float mu = c[8 * kSteps];
  float g = c[8 * kSteps + 1];
  const long long c0 = clock64(), t0 = global_ns();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const float num = __fadd_rn(__fadd_rn(g, a[i]), b[i]);
      const float mag = fmaxf(__fsub_rn(fabsf(num), l1[i]), 0.f);
      const float sgn = num > 0.f ? 1.f : (num < 0.f ? -1.f : 0.f);
      const float q0 = __fmul_rn(mag, rcp[i]);
      const float q = __fmaf_rn(rcp[i], __fmaf_rn(-dv[i], q0, mag), q0);
      const float d = __fsub_rn(__fmul_rn(sgn, q), bt[i]);
      const float md = __fmul_rn(mu, __fsub_rn(d, din[i]));
      g = __fsub_rn(g, __fmul_rn(md, gs[i]));
    }
  }
  const long long c1 = clock64(), t1 = global_ns();
  out[0] = c1 - c0;
  out[1] = t1 - t0;
  sink[0] = g;
}

// One warp runs the panel loop of cd_chain.cuh `reps` times over the first
// 32 coordinates of a tile G (T, T), chained through acc (acc * 0 is 0 for
// finite acc) so that passes cannot overlap.
__global__ void __launch_bounds__(32)
    design_chain_kernel(const float* __restrict__ G,
                        const float* __restrict__ g,
                        const float* __restrict__ beta,
                        const float* __restrict__ params, int T, int reps,
                        long long* __restrict__ out,
                        float* __restrict__ sink) {
  using namespace repro::chain;
  __shared__ __align__(16) float stage[kStage];
  const int k = threadIdx.x;
  const float mu = params[0];
  const Coord c(G[(long long)k * T + k], beta[k], 0.f, 1.f, mu, params[1],
                params[2], params[3]);
  float Gd[kPanel];
  load_block(G, T, false, 0, 0, stage, Gd);
  const float g0 = g[k];
  float acc = 0.f, dk = 0.f;
  __syncwarp();
  const long long c0 = clock64(), t0 = global_ns();
  for (int r = 0; r < reps; ++r) {
    float gk = __fadd_rn(g0, __fmul_rn(acc, 0.f));
    dk = 0.f;
    acc = __fadd_rn(acc, panel(c, gk, dk, Gd, mu, k));
  }
  __syncwarp();
  const long long c1 = clock64(), t1 = global_ns();
  if (k == 0) {
    out[0] = c1 - c0;
    out[1] = t1 - t0;
  }
  sink[k] = acc + dk;
}

}  // namespace

// out: two device int64, the timed loop's SM cycles and nanoseconds over
// reps * 16 steps; sink: one float.
extern "C" int chain_floor_minimal(const float* consts, int reps,
                                   long long* out, float* sink,
                                   void* stream) {
  if (reps <= 0) return (int)cudaErrorInvalidValue;
  minimal_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, reps, out, sink);
  return (int)cudaGetLastError();
}

// G (T, T), g, beta (T,), T >= 32, params (4,) [mu, nu, lam1, lam2]; out as
// above over reps * 32 steps; sink: 32 floats.
extern "C" int chain_floor_design(const float* G, const float* g,
                                  const float* beta, const float* params,
                                  int T, int reps, long long* out,
                                  float* sink, void* stream) {
  if (T < 32 || reps <= 0) return (int)cudaErrorInvalidValue;
  design_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      G, g, beta, params, T, reps, out, sink);
  return (int)cudaGetLastError();
}
