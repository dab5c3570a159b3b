// Shared helpers of the port's row-movement kernels (plain C interface,
// bound from Python with ctypes; see repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Widest access (16, 8, 4, 2 or 1 bytes) that divides the row pitch and
// both base addresses, so every row start of both arrays is aligned to it.
static inline int access_width(long long row_bytes, const void* a,
                               const void* b) {
  for (int w = 16; w > 1; w >>= 1) {
    if (row_bytes % w == 0 && reinterpret_cast<uintptr_t>(a) % w == 0 &&
        reinterpret_cast<uintptr_t>(b) % w == 0)
      return w;
  }
  return 1;
}

// The block's threads copy one row of row_bytes bytes in accesses of V;
// neighbouring threads touch neighbouring addresses.
template <typename V>
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long row_bytes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long nv = row_bytes / static_cast<long long>(sizeof(V));
#pragma unroll 4
  for (long long k = threadIdx.x; k < nv; k += blockDim.x) d[k] = s[k];
}

// Threads of a row-copy block: a 7168-wide bf16 row is 896 16-byte
// accesses, seven per thread.
constexpr int kCopyThreads = 128;

// Hopper's bulk copies (TMA without a tensor map). Addresses are 16-byte
// aligned and sizes multiples of 16. A load completes on an mbarrier in
// shared memory; stores are tracked in bulk groups, whose ".read" wait says
// that their source in shared memory may be overwritten.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory written by this thread's ordinary stores becomes visible to
// the bulk copies issued after the next block barrier.
__device__ __forceinline__ void fence_smem_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, uint32_t smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every bulk group of this thread but the newest `Pending` has finished
// reading its source.
template <int Pending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(Pending)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and add `bytes` to the transfer count its current
// phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk load of `bytes` from global memory into shared memory; completes on
// `bar` (whose phase must expect these bytes).
__device__ __forceinline__ void bulk_load(uint32_t smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
