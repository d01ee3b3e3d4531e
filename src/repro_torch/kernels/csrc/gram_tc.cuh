// The weighted-Gram core shared by K3 (tile_gram.cu) and K5
// (stats_gram_solve.cu): one upper-triangle block of
//   G = X^T diag(w) X   and, on diagonal blocks,   g = X^T s
// over a stream of 32-row slabs of a (rows x T) operand, on Hopper's tensor
// cores with the 3xTF32 split.
//
// Why 3xTF32.  G is bound by arithmetic (about T / 4 flops per byte read),
// so the lever is the tensor cores: 495 TFLOP/s of TF32 against 67 of fp32
// FMA.  Plain TF32 keeps 11 significant bits (about 5e-4 a product), which
// misses the 1e-5 bar the solver holds beta to.  So each operand is split
// once, when it is staged: a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (round to nearest, ties away, as cvt.rna), and G accumulates lo*hi +
// hi*lo + hi*hi in fp32 (lo*lo, about 2^-22 of the product, is dropped):
// about 22 of fp32's 24 bits for three TF32 products, an effective
// 165 TFLOP/s at peak.
//
// Design, for a band edge BN (128, or 64 when T is not a multiple of 128).
// A block owns one BN x BN block (bi <= bj) of G; only blocks on and above
// the diagonal exist, and the caller's reduce pass mirrors them.  Its
// warpgroups are specialized and hand slabs over through named barriers
// (with one group doing everything in turn, the tensor cores sat idle most
// of each slab):
//   * the producer: one thread asks TMA for the next slab (32 rows of the
//     block's one or two column ranges, as 32 x 32 boxes in the 128-byte
//     swizzle, into a ring of 3 stages, an mbarrier a stage; per-thread
//     cp.async copies, tried first, stalled the threads that issued
//     them); one warp forms the slab's (w, s) from inputs it fetched a
//     slab earlier, so no global load latency stalls a slab; all of it
//     splits B (the j columns) into hi and lo and writes them transposed,
//     rows contiguous per feature, into the K-major layout wgmma reads
//     from shared memory (TF32 operands there must be K-major and X is
//     row-major), in the 128-byte swizzle: feature f's 32 rows are 128
//     bytes, 16-byte chunk c at c ^ (f % 8).  The staged B is
//     double-buffered, so slab s + 1 is staged while slab s's products run;
//   * BN / 64 consumers, each for 64 rows of the block: every thread reads
//     its A fragment (w times the i columns) from the raw slab, splits it
//     and hands it to wgmma m64nBNk8 in registers, a k step of 8 rows at a
//     time, two steps in flight.  Shared memory, not the tensor cores, runs
//     out first (a TF32 wgmma reads a byte of B for every 32 flops, and the
//     staging adds as much again), so A does not pass through it.  The
//     accumulators stay in registers; diagonal blocks also form g for
//     their BN columns on the FMA pipes (T x rows work beside T^2 x rows).
// Rows past the tensor's end are zero-filled, and rows past the stream's
// end (the next brick or row range) get w = s = 0, so they add 0.
// Sums: the accumulators are drained into a second float32 sum in shared
// memory every 4 slabs (128 rows), and the partial of a row range is the
// third level, added by the caller's reduce pass in a fixed order (no
// atomics): a range is thousands of near-equal terms (the intercept
// column's diagonal sums w), and one float32 chain over them would drift by
// up to rows x 6e-8.
// The caller gives a 2D tensor map (rows x columns, fp32, 32 x 32 boxes,
// 128-byte swizzle; make_map below) and a Src for the slab rows and their
// (w, s):
//   int slab_row(int s)             the map row of slab s's first row;
//   In fetch(int s, int r)          issues the loads row r of slab s needs
//                                   for its (w, s), returned in registers;
//   void stats(const In&, int s, int r, float& w, float& v)   forms them,
//                                   0 past the end.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace gram {

constexpr int kSlab = 32;    // rows per slab
constexpr int kStages = 3;   // raw slabs in the ring
constexpr int kDrain = 4;    // slabs per accumulator chunk

template <int BN>
__host__ __device__ constexpr int threads() {
  return 128 * (BN / 64 + 1);   // BN / 64 consumer warpgroups, 1 producer
}

template <int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024                                         // for alignment
         + sizeof(float) * (2 * 2 * BN * kSlab          // staged B hi / lo
                            + kStages * 2 * kSlab * BN  // raw ring
                            + BN * BN                   // second-level sums
                            + 2 * 2 * kSlab);           // w and s per slab
}

// (bi, bj), bi <= bj, of upper-triangle block pair ``pair`` (row-major)
__device__ inline void pair_coords(int pair, int nb, int& bi, int& bj) {
  bi = 0;
  while (pair >= nb - bi) {
    pair -= nb - bi;
    ++bi;
  }
  bj = bi + pair;
}

__device__ inline int pair_index(int bi, int bj, int nb) {
  return bi * nb - bi * (bi - 1) / 2 + (bj - bi);
}

// fp32 -> TF32 rounded to nearest, ties away from zero, on the low 13
// mantissa bits: what cvt.rna.tf32.f32 gives for finite inputs, in two
// integer instructions (the conversion instruction was slower)
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barrier expects ``bytes`` more of TMA transfers (and one arrival)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one 32 x 32 box of the map at (column x, row y) into shared memory
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy stores to shared memory become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers between the producer and the consumer warpgroups
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 32 fp32 (128 bytes) whose 16-byte chunk c sits at
// c ^ (row % 8), 8-row groups 1024 bytes apart (SBO), LBO unused (1);
// fields in 16-byte units, layout type 1 (bits 62-63).  A k step of 8
// columns starts 32 bytes further into the same rows.
__device__ __forceinline__ uint64_t make_desc(const float* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// m64n64k8, A from registers, 32 accumulators a thread;
// d = a b + (keep ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// m64n128k8, A from registers, 64 accumulators a thread;
// d = a b + (keep ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// Accumulates the block (bi, bj) -- columns [ci, ci + BN) x [cj, cj + BN)
// of the tile -- over ``nslab`` slabs of ``src`` and writes it row-major to
// Gout (BN x BN); a diagonal block also writes g of its columns to gout.
// Called by all threads<BN>() threads of a block, with smem_bytes<BN>() of
// dynamic shared memory.
template <int BN, class Src>
__device__ void band(const Src& src, const CUtensorMap* map, int col0,
                     int nslab, int ci, int cj, bool diag,
                     float* __restrict__ Gout, float* __restrict__ gout) {
  constexpr int kThreads = threads<BN>();
  constexpr int kCons = 2 * BN;                // consumer threads
  constexpr int kAcc = BN / 2;                 // accumulators a thread
  constexpr int kStaged = BN * kSlab;          // floats of one hi or lo
  constexpr int kBox = 32 * 32;                // floats of one TMA box
  constexpr int kBoxes = BN / 32;              // boxes across a range
  // named barrier ids: slab parity b is staged (kFull + b) / consumed
  // (kEmpty + b)
  constexpr int kFull = 1, kEmpty = 3;
  extern __shared__ __align__(128) unsigned char smem_[];
  __shared__ __align__(8) uint64_t full[kStages];   // a raw stage landed
  // the swizzled boxes want 1024-byte alignment
  float* smem = reinterpret_cast<float*>(
      smem_ + ((1024 - (smem_addr(smem_) & 1023)) & 1023));
  float* staged = smem;                          // [2][B hi, B lo]
  float* raw = staged + 2 * 2 * kStaged;  // [kStages][2][kBoxes][32][32]
  float* tot = raw + kStages * 2 * kSlab * BN;   // [kAcc][kCons]
  float* ws = tot + kAcc * kCons;                // [2][kSlab]
  float* ss = ws + 2 * kSlab;                    // [2][kSlab]

  const int tid = threadIdx.x;
  const int nrange = diag ? 1 : 2;
  // (row r, feature f) of a raw slab range, as the 128-byte swizzle
  // places it
  auto at = [](int r, int f) {
    return (f >> 5) * kBox + r * 32 + ((((f >> 2) & 7) ^ (r & 7)) << 2) +
           (f & 3);
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, uniform across each warp in the compiler's eyes
  // too (wgmma in a branch it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg >= kCons / 128) {
    // ---- producer warpgroup: its first warp forms the stats (thread pt
    // for row pt of each slab), its second issues the copies; all of it
    // stages B
    constexpr int kProducers = 128;
    const int pt = tid - kCons;
    // one thread asks for slab s: BN / 32 boxes of each column range
    auto load = [&](int s) {
      float* dst = raw + (s % kStages) * 2 * kSlab * BN;
      uint64_t* bar = &full[s % kStages];
      mbar_expect(bar, nrange * BN * kSlab * sizeof(float));
      const int y = src.slab_row(s);
      for (int q = 0; q < nrange; ++q)
        for (int cb = 0; cb < kBoxes; ++cb)
          tma_load(dst + (q * kBoxes + cb) * kBox, map,
                   col0 + (q ? cj : ci) + 32 * cb, y, bar);
    };
    typename Src::In ahead{};   // inputs of the next slab's stats
    if (nslab > 0) {
      if (pt == 32) load(0);
      if (pt < kSlab) ahead = src.fetch(0, pt);
    }
    for (int s = 0; s < nslab; ++s) {
      const int b = s & 1;
      // staged[b], ws/ss[b] and the raw stage of slab s - 2 are free.
      // (Copies two slabs ahead, with the raw stages released as soon as
      // the consumers had read them, made the kernels slower: the producer
      // then also waited on the consumers' fragment reads.)
      if (s >= 2) bar_sync(kEmpty + b, kThreads);
      if (pt == 32 && s + 1 < nslab) load(s + 1);
      if (pt < kSlab) {
        src.stats(ahead, s, pt, ws[b * kSlab + pt], ss[b * kSlab + pt]);
        if (s + 1 < nslab) ahead = src.fetch(s + 1, pt);
      }
      mbar_wait(&full[s % kStages], (s / kStages) & 1);
      const float* rB =
          raw + (s % kStages) * 2 * kSlab * BN + (diag ? 0 : kSlab * BN);
      float* st = staged + b * 2 * kStaged;
      // B: split, transposed into the K-major layout
#pragma unroll 4
      for (int u = pt; u < BN * (kSlab / 4); u += kProducers) {
        const int f = u % BN;
        const int kq = u / BN;
        float hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = rB[at(4 * kq + q, f)];
          hi[q] = to_tf32(x);
          lo[q] = to_tf32(x - hi[q]);
        }
        float* dh = st + f * kSlab + ((kq ^ (f & 7)) << 2);
        *reinterpret_cast<float4*>(dh) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(dh + kStaged) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();
      bar_arrive(kFull + b, kThreads);
    }
    // the consumers' last release (slab nslab - 2) is met here
    if (nslab >= 2) bar_sync(kEmpty + (nslab & 1), kThreads);
    return;
  }

  // ---- consumer warpgroups: A fragments and the products
  const int lane = tid % 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc[i] = 0.f;
    tot[i * kCons + tid] = 0.f;
  }
  // A fragments of two k steps of 8 rows: [slot][hi, lo][register];
  // register q holds (feature m, row k) with m = 16 warp + lane / 4 (+ 8
  // for q = 1, 3) and k = 8 step + lane % 4 (+ 4 for q = 2, 3), the
  // warpgroup's m64k8 layout.  Each k step's three products are one wgmma
  // group; a slot is refilled once the group two steps back is done.
  uint32_t afr[2][2][4];
  const int m = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  float gtot = 0.f;

  // chunks of kDrain slabs: the first product of a chunk overwrites the
  // accumulators (keep = 0), so no instruction but wgmma writes them, and
  // they are read only once the chunk's products are all done
  for (int c0 = 0; c0 < nslab; c0 += kDrain) {
    const int c1 = min(c0 + kDrain, nslab);
    for (int s = c0; s < c1; ++s) {
      const int b = s & 1;
      bar_sync(kFull + b, kThreads);
      mbar_wait(&full[s % kStages], (s / kStages) & 1);
      const float* rA = raw + (s % kStages) * 2 * kSlab * BN;
      const float* wsl = ws + b * kSlab;
      const float* st = staged + b * 2 * kStaged;
      if (diag && tid < BN) {   // g of column tid on the FMA pipes
        const float* ssl = ss + b * kSlab;
        float gs = 0.f;
#pragma unroll 8
        for (int r = 0; r < kSlab; ++r) gs += rA[at(r, tid)] * ssl[r];
        gtot += gs;
      }
#pragma unroll
      for (int ks = 0; ks < kSlab / 8; ++ks) {
        const int slot = ks & 1;
        wgmma_wait<1>();
        // every group of slab s - 1 is done: its buffers go back
        if (ks == 1 && s >= 1) bar_arrive(kEmpty + (b ^ 1), kThreads);
        // A: w times the raw slab, split, into this thread's fragment
        const int k = 8 * ks + lane % 4;
        const float w0 = wsl[k], w1 = wsl[k + 4];
        const float x[4] = {rA[at(k, m)] * w0, rA[at(k, m + 8)] * w0,
                            rA[at(k + 4, m)] * w1,
                            rA[at(k + 4, m + 8)] * w1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float hi = to_tf32(x[q]);
          afr[slot][0][q] = __float_as_uint(hi);
          afr[slot][1][q] = __float_as_uint(to_tf32(x[q] - hi));
        }
        wgmma_fence();
        const uint64_t b_hi = make_desc(st + ks * 8);
        const uint64_t b_lo = make_desc(st + kStaged + ks * 8);
        wgmma_tf32(acc, afr[slot][1], b_hi, s > c0 || ks > 0);
        wgmma_tf32(acc, afr[slot][0], b_lo, 1);
        wgmma_tf32(acc, afr[slot][0], b_hi, 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) tot[i * kCons + tid] += acc[i];
  }

  // accumulator layout of wgmma m64nN: register 4j + {0, 1, 2, 3} holds
  // (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) with r = 16 warp + lane
  // / 4 and c = 8 j + 2 (lane % 4), rows counted within the warpgroup's 64
  const int r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float* t = tot + 4 * j * kCons + tid;
    *reinterpret_cast<float2*>(Gout + r * BN + c) =
        make_float2(t[0], t[kCons]);
    *reinterpret_cast<float2*>(Gout + (r + 8) * BN + c) =
        make_float2(t[2 * kCons], t[3 * kCons]);
  }
  if (diag && tid < BN) gout[tid] = gtot;
}

// A 2D tensor map over a row-major fp32 (rows x cols) array with a row
// stride of ld floats, in 32 x 32 boxes with the 128-byte swizzle; band
// reads its slabs through it.  An empty array gets a zero map (no slab is
// then loaded).
inline cudaError_t make_map(CUtensorMap* map, const float* base,
                            long long rows, long long cols, long long ld) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  *map = CUtensorMap{};
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  cuuint32_t box[2] = {32, 32};
  cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets a band kernel take its dynamic shared memory (above 48 KB); set
// before each launch, as the attribute belongs to the current device.
template <class Kernel>
inline cudaError_t allow_smem(Kernel* k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gram
}  // namespace repro
