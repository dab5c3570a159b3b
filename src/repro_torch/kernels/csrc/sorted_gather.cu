// Sorted row gather: out[i] = table[sorted_idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/sorted_gather/kernel.py
// (gather_rows), which walks the sorted indices one grid step at a time and
// skips the HBM fetch when a block repeats.
//
// Bound on the H100: bytes. The function reads each distinct row once and
// writes n rows; there is no arithmetic. Design: one block per sorted slot,
// copying the row with the widest aligned access (16 bytes for any row whose
// pitch and base are 16-byte aligned, e.g. a 7168-wide bf16 row), so every
// warp moves 512 contiguous bytes per access. A CUDA grid has no order, so
// the TPU's skip-on-repeat has no counterpart here: duplicate rows of a run
// are re-read, mostly from L2 because a run's slots are neighbours in the
// grid. Offsets are 64-bit (row * row_bytes passes 2^31 at a 64000 x 7168
// table). Reading each run's row once and storing it to all its slots is
// later work.
#include "common.cuh"

template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
gather_rows_kernel(const char* __restrict__ table,
                   const int* __restrict__ sorted_idx,
                   char* __restrict__ out, long long row_bytes) {
  const long long i = blockIdx.x;
  const long long row = sorted_idx[i];
  copy_row<V>(out + i * row_bytes, table + row * row_bytes, row_bytes);
}

template <typename V>
static void launch(const void* table, const void* idx, void* out,
                   long long n, long long row_bytes, cudaStream_t stream) {
  gather_rows_kernel<V><<<static_cast<unsigned>(n), kCopyThreads, 0,
                          stream>>>(
      static_cast<const char*>(table), static_cast<const int*>(idx),
      static_cast<char*>(out), row_bytes);
}

// table: (R, row_bytes) bytes; sorted_idx: (n,) int32 in [0, R), checked by
// the caller; out: (n, row_bytes) bytes. 1 <= n < 2^31.
extern "C" int gather_rows(const void* table, const void* sorted_idx,
                           void* out, long long n, long long row_bytes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (access_width(row_bytes, table, out)) {
    case 16: launch<uint4>(table, sorted_idx, out, n, row_bytes, s); break;
    case 8: launch<uint2>(table, sorted_idx, out, n, row_bytes, s); break;
    case 4: launch<unsigned int>(table, sorted_idx, out, n, row_bytes, s); break;
    case 2: launch<unsigned short>(table, sorted_idx, out, n, row_bytes, s); break;
    default: launch<unsigned char>(table, sorted_idx, out, n, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
