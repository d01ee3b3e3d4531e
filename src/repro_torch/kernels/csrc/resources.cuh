// What a kernel of this library asks of the card, for the port's audit
// (repro_torch.kernels.ops.kernel_resources, analysis/audit.py).
//
// Each .cu file lists its __global__ functions (every template instance
// its launchers can take) in a table of KernelSlot, and its launchers note
// on the host, before each launch, the dynamic shared memory and threads
// the launch asks for (note_launch): running maxima since the library was
// loaded.  The file's one exported entry, repro_<file>_resources, fills
// a KernelResources record a slot from cudaFuncGetAttributes (registers,
// static shared bytes, local bytes a thread, the dynamic shared cap set
// by cudaFuncSetAttribute, the most threads a block can have) and those
// maxima.  Nothing here runs on the card or adds work to a kernel.
#pragma once

#include <atomic>
#include <cstring>

#include <cuda_runtime.h>

namespace repro {

// One record of repro_<file>_resources; kernels/build.py's ctypes
// Structure KernelResources mirrors it field for field.
struct KernelResources {
  char name[96];
  int regs;                    // registers a thread
  int static_smem;             // static shared bytes a block
  int local_bytes;             // local memory a thread (stack, spills)
  int max_dynamic_smem;        // the dynamic shared cap of the function
  int max_threads;             // the most threads a block can launch with
  int requested_dynamic_smem;  // the most a launch asked for since load
  int requested_threads;       // the most threads a block a launch asked
  int launches;                // launches noted since load
};

struct KernelSlot {
  const void* fn;
  const char* name;
};

struct LaunchMax {
  std::atomic<int> smem{0};
  std::atomic<int> threads{0};
  std::atomic<int> launches{0};
};

inline void raise_to(std::atomic<int>& m, int v) {
  int cur = m.load(std::memory_order_relaxed);
  while (v > cur && !m.compare_exchange_weak(cur, v,
                                             std::memory_order_relaxed)) {
  }
}

// Note a launch of fn with smem dynamic shared bytes and threads a block;
// a function outside the table is a fault of the table, and is refused so
// that the launch never runs uncounted.
template <int N>
cudaError_t note_launch(const KernelSlot (&slots)[N], LaunchMax (&mx)[N],
                        const void* fn, size_t smem, int threads) {
  for (int i = 0; i < N; ++i) {
    if (slots[i].fn == fn) {
      raise_to(mx[i].smem, (int)smem);
      raise_to(mx[i].threads, threads);
      mx[i].launches.fetch_add(1, std::memory_order_relaxed);
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidDeviceFunction;
}

// Fill out[0 .. min(N, cap)) and set *n = N.
template <int N>
cudaError_t fill_resources(const KernelSlot (&slots)[N],
                           const LaunchMax (&mx)[N], KernelResources* out,
                           int cap, int* n) {
  *n = N;
  for (int i = 0; i < N && i < cap; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, slots[i].fn);
    if (err != cudaSuccess) return err;
    KernelResources& r = out[i];
    std::memset(&r, 0, sizeof r);
    std::strncpy(r.name, slots[i].name, sizeof r.name - 1);
    r.regs = a.numRegs;
    r.static_smem = (int)a.sharedSizeBytes;
    r.local_bytes = (int)a.localSizeBytes;
    r.max_dynamic_smem = a.maxDynamicSharedSizeBytes;
    r.max_threads = a.maxThreadsPerBlock;
    r.requested_dynamic_smem = mx[i].smem.load();
    r.requested_threads = mx[i].threads.load();
    r.launches = mx[i].launches.load();
  }
  return cudaSuccess;
}

}  // namespace repro

// The exported entry of one .cu file, over its table kSlots / kMax.
#define REPRO_RESOURCES_ENTRY(file)                                     \
  extern "C" int repro_##file##_resources(repro::KernelResources* out, \
                                          int cap, int* n) {           \
    return (int)repro::fill_resources(kSlots, kMax, out, cap, n);      \
  }
