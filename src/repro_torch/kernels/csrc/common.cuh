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
