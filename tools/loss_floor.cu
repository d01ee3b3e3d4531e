// The throughput floor of the per-example work of K4 alpha_search and K1
// glm_stats, on no path of the package.  chip_smoke.py builds this file
// with nvcc and times loss_floor_run through CUDA events.
//
// Mode 0 (K4): each thread runs kChains independent candidates of K4's
// inner step, m = b + alpha_k d (the product and the sum rounded apart),
// then part_k += loss(y, m) c, with Stats<F>::loss of
// src/repro_torch/kernels/csrc/glm_family.cuh, its inputs in registers
// and no memory traffic.  Mode 1 (K1): each thread runs kChains
// independent calls of Stats<F>::all at m = b + o_k, and its three outputs
// times c into three sums.  b moves by one rounded add a round, so no
// round can be folded into another.  The grid is one full wave (the
// occupancy API times the SM count), so the time over the work counted in
// *work is what the whole card needs for one candidate loss (or one row's
// statistics): n K times it (n times it) is the least time K4 (K1) can
// take for its losses.
#include <cuda_runtime.h>

#include "glm_family.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;        // independent candidates (rows) a thread

template <int F, int MODE>
__global__ void __launch_bounds__(kThreads)
    loss_probe(const float* __restrict__ in, int reps,
               float* __restrict__ sink) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = 4 * (i % 1024);
  const float y = in[j], d = in[j + 2], c = in[j + 3];
  float b = in[j + 1];
  float a[kChains], acc[kChains], acc_s[kChains], acc_w[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    a[k] = MODE == 0 ? 1e-3f * (float)(k + 1) * (float)(k + 1)
                     : 0.05f * (float)(k - kChains / 2);
    acc[k] = acc_s[k] = acc_w[k] = 0.f;
  }
  for (int r = 0; r < reps; ++r) {
    b = __fadd_rn(b, 1e-7f);
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (MODE == 0) {
        const float m = __fadd_rn(b, __fmul_rn(a[k], d));
        acc[k] += __fmul_rn(repro::Stats<F>::loss(y, m), c);
      } else {
        float l, s, w;
        repro::Stats<F>::all(y, __fadd_rn(b, a[k]), l, s, w);
        acc[k] += l * c;
        acc_s[k] += s * c;
        acc_w[k] += w * c;
      }
    }
  }
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) tot += acc[k] + acc_s[k] + acc_w[k];
  sink[i] = tot;
}

template <int F>
const void* probe_of(int mode) {
  return mode == 0 ? (const void*)loss_probe<F, 0>
                   : (const void*)loss_probe<F, 1>;
}

}  // namespace

// One launch of the probe for ``family`` (0 logistic, 1 squared, 2
// probit, 3 poisson) and ``mode`` (0: K4's candidate loss, 1: K1's row
// statistics), ``reps`` rounds a thread.  ``in``: 4096 floats, (y, b, d,
// c) of 1024 rows; ``sink``: a float a thread, *threads of them.  *work:
// the losses (rows) computed.
extern "C" int loss_floor_run(int family, int mode, int reps,
                              const float* in, float* sink, int* threads,
                              long long* work, void* stream) {
  const void* fn = nullptr;
  switch (family) {
    case repro::kLogistic: fn = probe_of<repro::kLogistic>(mode); break;
    case repro::kSquared: fn = probe_of<repro::kSquared>(mode); break;
    case repro::kProbit: fn = probe_of<repro::kProbit>(mode); break;
    case repro::kPoisson: fn = probe_of<repro::kPoisson>(mode); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if ((mode != 0 && mode != 1) || reps < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, 0)) != cudaSuccess)
    return (int)err;
  const int blocks = sms * per_sm;
  *threads = blocks * kThreads;
  *work = (long long)*threads * kChains * reps;
  void* args[] = {&in, &reps, &sink};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
