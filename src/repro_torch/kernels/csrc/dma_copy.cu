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
// may exceed a slot (up to 256 KB at the Table I maximum), so each block
// stages pieces of at most one slot through a ring of `channels` slots.
// Two routes, chosen by alignment:
// - "tma" (both addresses, the chunk and the total 16-byte aligned, e.g.
//   a bulk read of a weight): Hopper's bulk copies, issued by one thread.
//   A slot holds a whole 16 KB chunk. Its inbound semaphore is an mbarrier:
//   a bulk load (cp.async.bulk...mbarrier::complete_tx) lands the piece,
//   and the thread waits on the slot's phase. Its outbound semaphore is a
//   bulk group: the piece leaves by a bulk store (cp.async.bulk...bulk_group),
//   and once the group's ".read" wait says the store has read the slot, the
//   slot takes the piece `channels` later. No byte passes through registers.
// - "cp_async" (anything else, e.g. a bulk write at an odd bf16 offset,
//   2-byte aligned, or a chunk under 16 bytes): 8 KB pieces go in by
//   cp.async (one group per piece is the inbound semaphore) and out through
//   the block's threads, and the __syncthreads after the write is the
//   outbound semaphore. The access width is the widest (8, 4, 2 or 1 bytes)
//   that divides the chunk, the total and both addresses; cp.async takes 4
//   or 8 bytes, and at 2 and 1 the inbound copy goes through registers.
// Host side: the occupancy, the card's SM count and the shared-memory
// attribute are looked up once per device, kernel and slot size, so a call
// is one launch.
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

constexpr int kMaxChannels = 8;
constexpr int kTmaThreads = 32;            // one warp; lane 0 runs the ring
constexpr long long kTmaSlotBytes = 16384;  // a whole 16 KB chunk
constexpr int kDmaThreads = 256;
constexpr long long kSlotBytes = 8192;  // one cp.async slot: a piece of a chunk

// Pieces of this block: its chunks c = blockIdx.x + k * gridDim.x, each cut
// into pieces of at most `slot` bytes; the block's last chunk may be the
// copy's ragged end, with fewer pieces. piece(j, &len) gives piece j's byte
// offset and length (len > 0 for every j < count).
struct Pieces {
  long long total, chunk, slot, per_chunk, count;

  __device__ Pieces(long long total_, long long chunk_, long long slot_)
      : total(total_), chunk(chunk_), slot(slot_) {
    const long long num_chunks = (total + chunk - 1) / chunk;
    per_chunk = (chunk + slot - 1) / slot;
    const long long mine =
        (num_chunks - 1 - static_cast<long long>(blockIdx.x)) / gridDim.x + 1;
    const long long last = blockIdx.x + (mine - 1) * gridDim.x;
    const long long len =
        total - last * chunk < chunk ? total - last * chunk : chunk;
    count = (mine - 1) * per_chunk + (len + slot - 1) / slot;
  }

  __device__ long long piece(long long j, long long* len) const {
    const long long c = blockIdx.x + (j / per_chunk) * gridDim.x;
    const long long off = c * chunk + (j % per_chunk) * slot;
    long long end = c * chunk + chunk;
    if (end > total) end = total;
    if (end > off + slot) end = off + slot;
    *len = end - off;
    return off;
  }
};

__global__ void __launch_bounds__(kTmaThreads)
dma_copy_tma_kernel(char* __restrict__ dst, const char* __restrict__ src,
                    long long total, long long chunk, long long slot,
                    int channels) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t inbound[kMaxChannels];
  if (threadIdx.x != 0) return;
  const Pieces p(total, chunk, slot);
  for (int s = 0; s < channels; ++s) mbar_init(&inbound[s], 1);
  mbar_fence_init();
  auto load = [&](long long j) {
    const int s = static_cast<int>(j % channels);
    long long len;
    const long long off = p.piece(j, &len);
    mbar_expect_tx(&inbound[s], static_cast<uint32_t>(len));
    bulk_load(smem_addr(ring + s * slot), src + off,
              static_cast<uint32_t>(len), &inbound[s]);
  };
  for (long long j = 0; j < channels && j < p.count; ++j) load(j);
  // With two or more slots, a slot is refilled one piece after its store
  // was issued, so the store's read overlaps the next piece's wait.
  const long long lag = channels > 1 ? 1 : 0;
  for (long long j = 0; j < p.count; ++j) {
    const int s = static_cast<int>(j % channels);
    mbar_wait(&inbound[s], static_cast<uint32_t>((j / channels) & 1));
    long long len;
    const long long off = p.piece(j, &len);
    bulk_store(dst + off, smem_addr(ring + s * slot),
               static_cast<uint32_t>(len));
    bulk_commit();
    if (lag) {
      bulk_wait_read<1>();
    } else {
      bulk_wait_read<0>();
    }
    const long long freed = j - lag;  // its slot has been read out
    if (freed >= 0 && freed + channels < p.count) load(freed + channels);
  }
  bulk_wait_read<0>();
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "n"(N)
               : "memory");
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
dma_copy_cp_async_kernel(char* __restrict__ dst, const char* __restrict__ src,
                         long long total, long long chunk, long long slot,
                         int channels) {
  extern __shared__ __align__(16) char stage[];
  const Pieces p(total, chunk, slot);
  long long len;
  // Prologue: every slot gets an inbound copy (a group is committed per
  // slot even when it is empty, so the group count stays uniform).
  for (int s = 0; s < channels; ++s) {
    if (s < p.count) {
      const long long off = p.piece(s, &len);
      stage_in<V>(stage + s * slot, src + off, len);
    }
    cp_async_commit();
  }
  for (long long j = 0; j < p.count; ++j) {
    const long long s = j % channels;
    cp_async_wait(channels - 1);  // piece j has landed (this thread's part)
    __syncthreads();              // ... and every thread's
    const long long off = p.piece(j, &len);
    copy_row<V>(dst + off, stage + s * slot, len);
    __syncthreads();              // slot s is free again
    const long long next = j + channels;
    if (next < p.count) {
      const long long noff = p.piece(next, &len);
      stage_in<V>(stage + s * slot, src + noff, len);
    }
    cp_async_commit();
  }
  cp_async_wait(0);
}

// Blocks of `kernel` that the card holds at once with `smem` bytes of
// dynamic shared memory, looked up once per device, kernel and size; the
// first lookup for a kernel on a device also lets it take `max_smem`.
static cudaError_t resident_blocks(const void* kernel, int threads,
                                   int smem, int max_smem, int device,
                                   long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, long long> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, kernel, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = known[key] = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

template <typename Kernel>
static int launch(Kernel kernel, int threads, long long max_slot,
                  void* dst, const void* src, long long total,
                  long long chunk, int channels, int device,
                  cudaStream_t stream) {
  const long long slot = chunk < max_slot ? chunk : max_slot;
  const int smem = static_cast<int>(channels * slot);
  long long grid = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), threads, smem,
      static_cast<int>(kMaxChannels * max_slot), device, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long num_chunks = (total + chunk - 1) / chunk;
  if (grid > num_chunks) grid = num_chunks;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<char*>(dst), static_cast<const char*>(src), total, chunk,
      slot, channels);
  return static_cast<int>(cudaGetLastError());
}

// dst, src: total_bytes each, not overlapping, on CUDA device `device`
// (the current one); chunk_bytes: the transaction size in bytes (the
// reference's chunk_elems * itemsize); channels: 1..8.
extern "C" int dma_copy(void* dst, const void* src, long long total_bytes,
                        long long chunk_bytes, int channels, int device,
                        void* stream) {
  if (total_bytes <= 0 || chunk_bytes <= 0 || channels < 1 ||
      channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int w = access_width(chunk_bytes, dst, src);
  while (total_bytes % w) w >>= 1;
  const long long t = total_bytes, c = chunk_bytes;
  switch (w) {
    case 16:
      return launch(dma_copy_tma_kernel, kTmaThreads, kTmaSlotBytes, dst, src,
                    t, c, channels, device, s);
    case 8:
      return launch(dma_copy_cp_async_kernel<uint2>, kDmaThreads, kSlotBytes,
                    dst, src, t, c, channels, device, s);
    case 4:
      return launch(dma_copy_cp_async_kernel<unsigned int>, kDmaThreads,
                    kSlotBytes, dst, src, t, c, channels, device, s);
    case 2:
      return launch(dma_copy_cp_async_kernel<unsigned short>, kDmaThreads,
                    kSlotBytes, dst, src, t, c, channels, device, s);
    default:
      return launch(dma_copy_cp_async_kernel<unsigned char>, kDmaThreads,
                    kSlotBytes, dst, src, t, c, channels, device, s);
  }
}
