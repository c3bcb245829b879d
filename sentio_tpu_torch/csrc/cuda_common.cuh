// Device helpers shared by the paged-decode and flash kernels: the card's
// own launch count, the cp.async 16-byte copy with its group fences, and a
// fast 2^x. Each kernel library is one translation unit, so this header is
// compiled once into each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sentio {

// Launches of this library's kernels as the card counted them, one slot
// each: 0 the split (or flash) kernel, 1 the paged combine. A launch from a
// CUDA graph replay counts like any other; a capture runs nothing and adds
// nothing. Read with sentio_device_launches.
__device__ unsigned long long device_launches[2];

// The first thread of block (0, 0, 0) adds one to slot's count: called first
// thing in a kernel, before any early return.
__device__ __forceinline__ void count_launch(int slot) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x) == 0) {
    atomicAdd(&device_launches[slot], 1ull);
  }
}

// 2^x on the special-function unit (one MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without staging in registers.
// With src_bytes == 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace sentio

// Copy the library's launch counts (sentio::device_launches) into counts[2];
// waits for the device.
extern "C" int sentio_device_launches(unsigned long long* counts) {
  return (int)cudaMemcpyFromSymbol(counts, sentio::device_launches,
                                   sizeof(sentio::device_launches));
}
