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
// in L2, so the work is microseconds against a launch of about as much; what
// is left to the kernel is the latency of its two dependent loads (a slot,
// then its table row).
// Design: a group of G lanes a row (8, 16 or 32, from J and B: see
// lanes_per_row), so a warp serves 32 / G rows.  With J a multiple of 4 a
// lane loads its slots and values as 16-byte vectors (vector v = 4 pairs,
// lane i of the group the vectors i + G q), else one pair at a time (pairs
// i + G q); either way it issues all its slot and value loads of a pass (up
// to kQ vectors, or 4 kQ pairs), then all their table rows (one 16-byte load
// a row when L is a multiple of 4), before its first FMA.  Its intercept is
// loaded before all of them.  The group sums its L live outputs, 4 at a
// time, with a shuffle tree of log2 G levels, and lane l of the group adds
// b0[l], applies the link and writes output l.  The TPU kernel's padding of
// J and L to 128 lanes and the table to 8 sublanes is gone.  A slot outside
// the table reads the zero row, so a malformed request can never read past
// the table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "resources.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 2;          // 4-pair vectors a lane loads before its FMAs
constexpr int kL = 4;          // outputs summed per pass over a row
constexpr int kSmallBatch = 256;   // rows: up to this, a vector a lane
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

struct Table {
  const float* t;
  int A1, L;
  bool vec;       // L % 4 == 0 and the table 16-byte aligned

  // row ``slot`` (the zero row when outside the table), columns l0 .. l0+3
  __device__ __forceinline__ float4 row(int slot, int l0, int lw) const {
    if (slot < 0 || slot >= A1) slot = A1 - 1;
    const float* p = t + (long long)slot * L + l0;
    if (vec) return __ldg(reinterpret_cast<const float4*>(p));
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x = __ldg(p);
    if (lw > 1) r.y = __ldg(p + 1);
    if (lw > 2) r.z = __ldg(p + 2);
    if (lw > 3) r.w = __ldg(p + 3);
    return r;
  }
};

__device__ __forceinline__ void fma4(float* acc, float v, const float4& t) {
  acc[0] = fmaf(v, t.x, acc[0]);
  acc[1] = fmaf(v, t.y, acc[1]);
  acc[2] = fmaf(v, t.z, acc[2]);
  acc[3] = fmaf(v, t.w, acc[3]);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    predict_tile_kernel(const int* __restrict__ slots,
                        const float* __restrict__ vals, int B, int J,
                        Table table, const float* __restrict__ b0,
                        float* __restrict__ out, int link, bool vec_pairs) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t / G;
  const int li = t % G;         // lane in the row's group
  const bool live = b < B;      // dead lanes still join the shuffles
  const long long rb = (long long)(live ? b : 0) * J;
  const int nv = vec_pairs ? J / 4 : 0;     // 4-pair vectors of a row
  const int js = 4 * nv;                    // first pair of the scalar rest
  for (int l0 = 0; l0 < table.L; l0 += kL) {
    const int lw = min(kL, table.L - l0);
    // the lane's intercept, loaded ahead of the row's chain of loads
    const float bias = live && li < lw ? __ldg(b0 + l0 + li) : 0.f;
    float acc[kL] = {0.f, 0.f, 0.f, 0.f};
    for (int v0 = 0; v0 < nv; v0 += G * kQ) {
      int4 sv[kQ];
      float4 xv[kQ];
      bool in[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int v = v0 + li + G * q;
        in[q] = live && v < nv;
        if (in[q]) {
          sv[q] = __ldg(reinterpret_cast<const int4*>(slots + rb) + v);
          xv[q] = __ldg(reinterpret_cast<const float4*>(vals + rb) + v);
        }
      }
      float4 tv[kQ][4];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (in[q]) {
          tv[q][0] = table.row(sv[q].x, l0, lw);
          tv[q][1] = table.row(sv[q].y, l0, lw);
          tv[q][2] = table.row(sv[q].z, l0, lw);
          tv[q][3] = table.row(sv[q].w, l0, lw);
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (in[q]) {
          fma4(acc, xv[q].x, tv[q][0]);
          fma4(acc, xv[q].y, tv[q][1]);
          fma4(acc, xv[q].z, tv[q][2]);
          fma4(acc, xv[q].w, tv[q][3]);
        }
      }
    }
    for (int j0 = js; j0 < J; j0 += G * 4 * kQ) {
      int sl[4 * kQ];
      float x[4 * kQ];
      bool in[4 * kQ];
#pragma unroll
      for (int q = 0; q < 4 * kQ; ++q) {
        const int j = j0 + li + G * q;
        in[q] = live && j < J;
        if (in[q]) {
          sl[q] = __ldg(slots + rb + j);
          x[q] = __ldg(vals + rb + j);
        }
      }
      float4 tv[4 * kQ];
#pragma unroll
      for (int q = 0; q < 4 * kQ; ++q)
        if (in[q]) tv[q] = table.row(sl[q], l0, lw);
#pragma unroll
      for (int q = 0; q < 4 * kQ; ++q)
        if (in[q]) fma4(acc, x[q], tv[q]);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      if (l < lw) {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], o);
      }
    }
    if (live && li < lw) {
      float m = acc[0];
#pragma unroll
      for (int l = 1; l < kL; ++l)
        if (li == l) m = acc[l];
      m += bias;
      out[(long long)b * table.L + l0 + li] = link < 0 ? m
                                                       : inverse_link(link, m);
    }
  }
}

// G, the lanes of a row's group.  A small batch (the serving buckets) is all
// latency: one 4-pair vector a lane, so each lane's loads are one round
// trip.  A large one (bulk scoring) fills the card: two vectors a lane, so
// fewer lanes share each row's shuffles.
int lanes_per_row(int B, int J) {
  const int vectors = (J + 3) / 4;
  const int per_lane = B <= kSmallBatch ? 1 : kQ;
  return vectors <= 8 * per_lane ? 8 : vectors <= 16 * per_lane ? 16 : 32;
}

const repro::KernelSlot kSlots[] = {
    {(const void*)predict_tile_kernel<8>, "predict_tile_kernel<8>"},
    {(const void*)predict_tile_kernel<16>, "predict_tile_kernel<16>"},
    {(const void*)predict_tile_kernel<32>, "predict_tile_kernel<32>"},
};
repro::LaunchMax kMax[sizeof kSlots / sizeof kSlots[0]];

template <int G>
cudaError_t launch(const int* slots, const float* vals, int B, int J,
                   Table table, const float* b0, float* out, int link,
                   bool vec_pairs, cudaStream_t st) {
  const long long threads = (long long)B * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  const cudaError_t err = repro::note_launch(
      kSlots, kMax, (const void*)predict_tile_kernel<G>, 0, kThreads);
  if (err != cudaSuccess) return err;
  predict_tile_kernel<G><<<blocks, kThreads, 0, st>>>(
      slots, vals, B, J, table, b0, out, link, vec_pairs);
  return cudaGetLastError();
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
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Table tab{table, A1, L, L % 4 == 0 && aligned(table)};
  const bool vec_pairs = J % 4 == 0 && aligned(slots) && aligned(vals);
  switch (lanes_per_row(B, J)) {
    case 8:
      return (int)launch<8>(slots, vals, B, J, tab, b0, out, link, vec_pairs,
                            st);
    case 16:
      return (int)launch<16>(slots, vals, B, J, tab, b0, out, link,
                             vec_pairs, st);
    default:
      return (int)launch<32>(slots, vals, B, J, tab, b0, out, link,
                             vec_pairs, st);
  }
}

REPRO_RESOURCES_ENTRY(predict_tile)
