// Bitonic sorting network over the rows of (G, N) int32 keys, N a power of
// two, carrying an int32 arrival id and an int32 payload through every
// compare-exchange.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort/kernel.py
// (bitonic_sort_batched), which holds one whole row in VMEM per grid step
// and runs the log2N(log2N+1)/2 stages on it.
//
// Bound on the H100: bytes. The function reads keys and payload once and
// writes keys, perm and payload once; its compare-exchanges are few integer
// operations per byte. Design: the composite order (key, id) is compared as
// the TPU kernel does, so the network is a total order and the result
// equals a stable sort; the pad keys INT32_MAX that ops.sort_with_indices
// appends sort after real INT32_MAX keys because their ids are larger. A
// row of the 1-D stream (32768 rows of keys, ids and payload, 384 KiB) is
// larger than one block's 227 KB of shared memory, and a CUDA grid has no
// order, so every stage is a global barrier: one launch per (k, j) stage,
// one thread per compare-exchange pair, all G rows in one grid, all stages
// queued on the stream by one C call. This makes the sort bound by launch
// latency, not bytes, at the slice's sizes; fusing the stages whose stride
// fits one block into shared memory is later work.
#include "common.cuh"

__global__ void bitonic_stage_kernel(int* __restrict__ keys,
                                     int* __restrict__ ids,
                                     int* __restrict__ vals, int log_n,
                                     int j_exp, int k_exp, long long pairs) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long row = t >> (log_n - 1);
  const int p = static_cast<int>(t & ((1LL << (log_n - 1)) - 1));
  // Pair p of the stage: slots a and b = a + 2^j of block c of width 2^(j+1).
  const int a = ((p >> j_exp) << (j_exp + 1)) + (p & ((1 << j_exp) - 1));
  const int b = a + (1 << j_exp);
  // Sub-blocks of width 2^k alternate ascending and descending.
  const bool ascending = ((a >> k_exp) & 1) == 0;
  const long long base = row << log_n;
  const int ka = keys[base + a], kb = keys[base + b];
  const int ia = ids[base + a], ib = ids[base + b];
  const bool gt = ka > kb || (ka == kb && ia > ib);
  if (gt == ascending) {
    keys[base + a] = kb;
    keys[base + b] = ka;
    ids[base + a] = ib;
    ids[base + b] = ia;
    const int va = vals[base + a];
    vals[base + a] = vals[base + b];
    vals[base + b] = va;
  }
}

// keys, ids, vals: (g, n) int32, sorted in place; n a power of two >= 2.
extern "C" int bitonic_sort_rows(void* keys, void* ids, void* vals, int g,
                                 int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const long long pairs = static_cast<long long>(g) * (n / 2);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
  for (int k_exp = 1; k_exp <= log_n; ++k_exp) {
    for (int j_exp = k_exp - 1; j_exp >= 0; --j_exp) {
      bitonic_stage_kernel<<<blocks, threads, 0, s>>>(
          static_cast<int*>(keys), static_cast<int*>(ids),
          static_cast<int*>(vals), log_n, j_exp, k_exp, pairs);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
