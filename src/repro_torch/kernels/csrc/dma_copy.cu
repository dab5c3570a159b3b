// Staged bulk copy: dst[0, total) = src[0, total), bytes, through shared-
// memory staging slots -- the DMA engine's data plane.
//
// Replaces the TPU kernel src/repro/kernels/dma_copy/kernel.py
// (dma_copy_chunked), which walks (num_chunks, chunk) in order on one core
// and keeps up to `channels` HBM->VMEM copies in flight, each slot guarded
// by an inbound and an outbound DMA semaphore.
//
// Bound on the H100: bytes. Every byte is read once and written once;
// there is no arithmetic. Design: the copy follows the reference's plan --
// chunks of chunk_bytes (max(128, max_transaction_bytes / itemsize)
// elements), the ragged last chunk masked here rather than padded in
// memory. A CUDA grid has no order, so a persistent grid of as many blocks
// as fit on the card takes chunks c = blockIdx.x (mod gridDim.x). A chunk
// may exceed shared memory (up to 256 KB at the Table I maximum), so each
// block stages pieces of at most kSlotBytes through a ring of `channels`
// slots: up to `channels` inbound cp.async copies are in flight (one
// cp.async group per piece is the inbound semaphore), and a piece is
// written out once its group has landed; the __syncthreads after the write
// is the outbound semaphore that frees the slot for the piece `channels`
// later. The copy does not look at the dtype: the access width is the
// widest (16, 8, 4, 2 or 1 bytes) that divides the chunk, the total and
// both addresses (a bulk write at an odd bf16 offset is 2-byte aligned).
// cp.async takes 4, 8 or 16 bytes; at 2 and 1 the inbound copy goes
// through registers.
#include "common.cuh"

constexpr int kDmaThreads = 256;
constexpr long long kSlotBytes = 8192;  // one staging slot: a piece of a chunk
constexpr int kMaxChannels = 8;

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The block's threads start copying len bytes of src into a slot.
template <typename V>
__device__ __forceinline__ void stage_in(char* slot, const char* src,
                                         long long len) {
  V* s = reinterpret_cast<V*>(slot);
  const V* g = reinterpret_cast<const V*>(src);
  const long long nv = len / static_cast<long long>(sizeof(V));
  for (long long k = threadIdx.x; k < nv; k += blockDim.x) {
    if constexpr (sizeof(V) >= 4) {
      cp_async<static_cast<int>(sizeof(V))>(s + k, g + k);
    } else {
      s[k] = g[k];
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kDmaThreads)
dma_copy_kernel(char* __restrict__ dst, const char* __restrict__ src,
                long long total, long long chunk, long long slot,
                int channels) {
  extern __shared__ __align__(16) char stage[];
  const long long num_chunks = (total + chunk - 1) / chunk;
  const long long per_chunk = (chunk + slot - 1) / slot;  // pieces a chunk
  const long long mine =
      (num_chunks - 1 - static_cast<long long>(blockIdx.x)) / gridDim.x + 1;
  const long long pieces = mine * per_chunk;
  // Byte range [off, off + len) of this block's piece j; len <= 0 past the
  // ragged end of the last chunk.
  auto piece = [&](long long j, long long* len) {
    const long long c = blockIdx.x + (j / per_chunk) * gridDim.x;
    const long long off = c * chunk + (j % per_chunk) * slot;
    long long end = c * chunk + chunk;
    if (end > total) end = total;
    if (end > off + slot) end = off + slot;
    *len = end - off;
    return off;
  };
  // Prologue: every slot gets an inbound copy (a group is committed per
  // slot even when it is empty, so the group count stays uniform).
  for (int s = 0; s < channels; ++s) {
    long long len = 0;
    const long long off = s < pieces ? piece(s, &len) : 0;
    if (len > 0) stage_in<V>(stage + s * slot, src + off, len);
    cp_async_commit();
  }
  for (long long j = 0; j < pieces; ++j) {
    const long long s = j % channels;
    cp_async_wait(channels - 1);  // piece j has landed (this thread's part)
    __syncthreads();              // ... and every thread's
    long long len;
    const long long off = piece(j, &len);
    if (len > 0) copy_row<V>(dst + off, stage + s * slot, len);
    __syncthreads();              // slot s is free again
    const long long next = j + channels;
    if (next < pieces) {
      const long long noff = piece(next, &len);
      if (len > 0) stage_in<V>(stage + s * slot, src + noff, len);
    }
    cp_async_commit();
  }
  cp_async_wait(0);
}

template <typename V>
static int launch(void* dst, const void* src, long long total,
                  long long chunk, int channels, cudaStream_t stream) {
  const long long slot = chunk < kSlotBytes ? chunk : kSlotBytes;
  const int smem = static_cast<int>(channels * slot);
  auto kernel = dma_copy_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kDmaThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetDevice(&device)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long num_chunks = (total + chunk - 1) / chunk;
  long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > num_chunks) grid = num_chunks;
  kernel<<<static_cast<unsigned>(grid), kDmaThreads, smem, stream>>>(
      static_cast<char*>(dst), static_cast<const char*>(src), total, chunk,
      slot, channels);
  return static_cast<int>(cudaGetLastError());
}

// dst, src: total_bytes each, not overlapping; chunk_bytes: the transaction
// size in bytes (the reference's chunk_elems * itemsize); channels: 1..8.
extern "C" int dma_copy(void* dst, const void* src, long long total_bytes,
                        long long chunk_bytes, int channels, void* stream) {
  if (total_bytes <= 0 || chunk_bytes <= 0 || channels < 1 ||
      channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int w = access_width(chunk_bytes, dst, src);
  while (total_bytes % w) w >>= 1;
  switch (w) {
    case 16: return launch<uint4>(dst, src, total_bytes, chunk_bytes, channels, s);
    case 8: return launch<uint2>(dst, src, total_bytes, chunk_bytes, channels, s);
    case 4: return launch<unsigned int>(dst, src, total_bytes, chunk_bytes, channels, s);
    case 2: return launch<unsigned short>(dst, src, total_bytes, chunk_bytes, channels, s);
    default: return launch<unsigned char>(dst, src, total_bytes, chunk_bytes, channels, s);
  }
}
