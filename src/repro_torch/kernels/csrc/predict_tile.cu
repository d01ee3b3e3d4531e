// K7 predict_tile: fused sparse scoring for serving -- gather, dot,
// intercept and inverse link in one launch.
//
// Replaces src/repro/kernels/predict_tile.py::predict_tile_pallas (TPU
// Pallas).  Request row b carries J (slot, value) pairs, a slot being a row
// of the active-set-compacted weight table (padding and inactive features
// point at its trailing all-zero row):
//   out[b, l] = link(sum_j vals[b, j] table[slots[b, j], l] + b0[l])
// with link the identity (kind "link") or the family's inverse link
// (kind "response"): sigmoid, identity, Phi(m) = erfc(-m / sqrt 2) / 2, exp.
//
// Bound on the card: launch latency.  A serving batch is a few thousand
// rows of tens of pairs, under a megabyte of requests and a table that sits
// in L2, so the work is microseconds against a launch of about as much.
// Design: one warp per request row, lanes over j; each lane gathers its
// table rows through the read-only cache and sums up to 8 outputs in
// registers, a shuffle sum finishes the row and the lanes of the outputs
// add the intercept, apply the link and write.  The TPU kernel's padding of
// J and L to 128 lanes and the table to 8 sublanes is gone.  A slot outside
// the table reads the zero row, so a malformed request can never read past
// the table.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kL = 8;          // outputs summed per pass over a row
constexpr float kSqrt2 = 1.4142135623730951f;

enum Link : int { kSigmoid = 0, kIdentity = 1, kPhi = 2, kExp = 3 };

__device__ inline float inverse_link(int link, float m) {
  switch (link) {
    case kSigmoid:
      return 1.f / (1.f + expf(-m));
    case kPhi:
      return 0.5f * erfcf(-m / kSqrt2);
    case kExp:
      return expf(m);
    default:
      return m;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    predict_tile_kernel(const int* __restrict__ slots,
                        const float* __restrict__ vals, int B, int J,
                        const float* __restrict__ table, int A1, int L,
                        const float* __restrict__ b0,
                        float* __restrict__ out, int link) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int* srow = slots + (long long)b * J;
  const float* vrow = vals + (long long)b * J;
  for (int l0 = 0; l0 < L; l0 += kL) {
    float acc[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) acc[l] = 0.f;
    for (int j = lane; j < J; j += 32) {
      int slot = srow[j];
      if (slot < 0 || slot >= A1) slot = A1 - 1;
      const float v = vrow[j];
      const float* trow = table + (long long)slot * L + l0;
#pragma unroll
      for (int l = 0; l < kL; ++l)
        if (l0 + l < L) acc[l] += v * __ldg(trow + l);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], o);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      if (lane == l && l0 + l < L) {
        const float m = acc[l] + b0[l0 + l];
        out[(long long)b * L + l0 + l] = inverse_link(link, m);
      }
    }
  }
}

}  // namespace

// slots (B, J) int32, vals (B, J) f32, table (A1, L) f32 whose last row is
// all zero, b0 (L,), out (B, L).  link: -1 for margins, else the family's
// inverse link (0 sigmoid, 1 identity, 2 Phi, 3 exp).
extern "C" int repro_predict_tile(const int* slots, const float* vals, int B,
                                  int J, const float* table, int A1, int L,
                                  const float* b0, float* out, int link,
                                  void* stream) {
  if (B <= 0 || J <= 0 || A1 <= 0 || L <= 0 || link < -1 || link > kExp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  predict_tile_kernel<<<blocks, kWarps * 32, 0, st>>>(
      slots, vals, B, J, table, A1, L, b0, out, link);
  return (int)cudaGetLastError();
}
