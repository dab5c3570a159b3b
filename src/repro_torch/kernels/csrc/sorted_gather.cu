// Sorted row gather: out[i] = table[sorted_idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/sorted_gather/kernel.py
// (gather_rows), which walks the sorted indices one grid step at a time and
// skips the HBM fetch when a block repeats.
//
// Bound on the H100: bytes. The function reads each distinct row once and
// writes n rows; there is no arithmetic. Design: a CUDA grid has no order,
// so the TPU's skip-on-repeat becomes a loop inside the block. Each block
// owns a span of kSpan consecutive sorted slots and one column tile of at
// most kTileBytes of the row. It loads a row's tile into shared memory only
// at the span's first slot and where the index changes, and stores it to
// every slot of that run within the span. So a run's row is read once per
// span it touches, a hot run of thousands of slots is spread over many
// blocks, and any index order still gives table[idx]: sorted order only
// makes it cheaper. Two routes:
// - "tma" (row pitch and both bases 16-byte aligned, e.g. a 7168-wide bf16
//   row): one thread moves every byte with Hopper's bulk copies, through a
//   ring of kStages tiles. A run's tile comes in by a bulk load that
//   completes on the tile's mbarrier, and leaves by one bulk store per slot
//   (cp.async.bulk.global.shared::cta.bulk_group); a tile takes the run
//   kStages later once the stores of the run after it have been issued and
//   its own have read it. Up to kStages - 1 loads stay in flight while the
//   stores drain, and no byte passes through registers. The load and the
//   stores both belong to the async proxy and the mbarrier orders them, so
//   no proxy fence is needed between them.
// - "vec" (anything else, e.g. a table view at a 2-byte offset): the
//   block's threads fill one tile with the widest access that the row pitch
//   and both bases allow (8, 4, 2 or 1 bytes) and store it to each slot of
//   the run with that access and a streaming hint.
// Offsets are 64-bit (row * row_bytes passes 2^31 at a 64000 x 7168 table).
#include "common.cuh"

#include <mutex>
#include <set>
#include <utility>

constexpr int kSpan = 4;                 // sorted slots of one block
constexpr long long kTileBytes = 16384;  // row bytes of one block
constexpr int kStages = 4;               // tiles in a "tma" block's ring
constexpr int kTmaThreads = 32;          // one warp; lane 0 moves the bytes
static_assert(kSpan <= 32 && kStages >= 2, "a span is one warp's lanes");

// Bytes of one shared-memory buffer: the widest tile, rounded up to 16.
__host__ __device__ inline long long tile_pitch(long long row_bytes) {
  const long long t = row_bytes < kTileBytes ? row_bytes : kTileBytes;
  return (t + 15) / 16 * 16;
}

// The block's threads store `count` copies of a tile of `bytes` bytes from
// shared memory, one to each of `count` rows `pitch` bytes apart.
template <typename V>
__device__ __forceinline__ void store_copies(char* __restrict__ dst,
                                             long long pitch,
                                             const char* __restrict__ src,
                                             long long bytes, int count) {
  const V* s = reinterpret_cast<const V*>(src);
  const long long nv = bytes / static_cast<long long>(sizeof(V));
  for (long long k = threadIdx.x; k < nv; k += blockDim.x) {
    const V v = s[k];
    for (int r = 0; r < count; ++r)
      __stcs(reinterpret_cast<V*>(dst + r * pitch) + k, v);
  }
}

__global__ void __launch_bounds__(kTmaThreads)
gather_rows_tma_kernel(const char* __restrict__ table,
                       const int* __restrict__ sorted_idx,
                       char* __restrict__ out, long long n,
                       long long row_bytes) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t landed[kStages];
  __shared__ int span[kSpan];
  const long long s0 = static_cast<long long>(blockIdx.x) * kSpan;
  const int m = n - s0 < kSpan ? static_cast<int>(n - s0) : kSpan;
  const int lane = static_cast<int>(threadIdx.x);
  // The span's indices, one per lane, and where its runs start (a bit per
  // slot).
  const int row = lane < m ? sorted_idx[s0 + lane] : -1;
  const int before = __shfl_up_sync(0xffffffffu, row, 1);
  unsigned to_store = __ballot_sync(0xffffffffu,
                                    lane < m && (lane == 0 || row != before));
  if (lane < kSpan) span[lane] = row;
  __syncwarp();
  if (lane != 0) return;
  const long long col = static_cast<long long>(blockIdx.y) * kTileBytes;
  const uint32_t tile = static_cast<uint32_t>(
      row_bytes - col < kTileBytes ? row_bytes - col : kTileBytes);
  const long long pitch = tile_pitch(row_bytes);
  for (int s = 0; s < kStages; ++s) mbar_init(&landed[s], 1);
  mbar_fence_init();
  unsigned to_load = to_store;
  const int runs = __popc(to_store);
  auto load = [&](int r) {  // run r, the next one not yet loaded
    const int i = __ffs(to_load) - 1;
    to_load &= to_load - 1;
    const int s = r % kStages;
    mbar_expect_tx(&landed[s], tile);
    bulk_load(smem_addr(ring + s * pitch),
              table + static_cast<long long>(span[i]) * row_bytes + col,
              tile, &landed[s]);
  };
  for (int r = 0; r < runs && r < kStages; ++r) load(r);
  for (int r = 0; r < runs; ++r) {
    const int i = __ffs(to_store) - 1;
    to_store &= to_store - 1;
    const int j = to_store ? __ffs(to_store) - 1 : m;  // the run [i, j)
    const int s = r % kStages;
    mbar_wait(&landed[s], static_cast<uint32_t>((r / kStages) & 1));
    char* dst = out + (s0 + i) * row_bytes + col;
    for (int k = 0; k < j - i; ++k)
      bulk_store(dst + k * row_bytes, smem_addr(ring + s * pitch), tile);
    bulk_commit();
    bulk_wait_read<1>();  // the stores of run r - 1 have read their tile
    if (r >= 1 && r - 1 + kStages < runs) load(r - 1 + kStages);
  }
  bulk_wait_read<0>();
}

template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
gather_rows_vec_kernel(const char* __restrict__ table,
                       const int* __restrict__ sorted_idx,
                       char* __restrict__ out, long long n,
                       long long row_bytes) {
  extern __shared__ __align__(128) char buf[];
  __shared__ int span[kSpan];
  const long long s0 = static_cast<long long>(blockIdx.x) * kSpan;
  const int m = n - s0 < kSpan ? static_cast<int>(n - s0) : kSpan;
  const long long col = static_cast<long long>(blockIdx.y) * kTileBytes;
  const long long tile =
      row_bytes - col < kTileBytes ? row_bytes - col : kTileBytes;
  if (threadIdx.x < m) span[threadIdx.x] = sorted_idx[s0 + threadIdx.x];
  for (int i = 0; i < m;) {
    __syncthreads();  // the span is in, and the last run's stores are done
    const long long row = span[i];
    int j = i + 1;
    while (j < m && span[j] == row) ++j;  // the run [i, j)
    copy_row<V>(buf, table + row * row_bytes + col, tile);
    __syncthreads();
    store_copies<V>(out + (s0 + i) * row_bytes + col, row_bytes, buf, tile,
                    j - i);
    i = j;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once per device and kernel.
static cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({device, kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({device, kernel});
  return err;
}

template <typename Kernel>
static void launch(Kernel kernel, int threads, int buffers, const void* table,
                   const void* idx, void* out, long long n,
                   long long row_bytes, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kSpan - 1) / kSpan),
                  static_cast<unsigned>((row_bytes + kTileBytes - 1) /
                                        kTileBytes));
  const size_t smem = static_cast<size_t>(buffers * tile_pitch(row_bytes));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const char*>(table), static_cast<const int*>(idx),
      static_cast<char*>(out), n, row_bytes);
}

// table: (R, row_bytes) bytes; sorted_idx: (n,) int32 in [0, R), checked by
// the caller; out: (n, row_bytes) bytes. 1 <= n < 2^31, row_bytes >= 1 and
// at most 65535 column tiles.
extern "C" int gather_rows(const void* table, const void* sorted_idx,
                           void* out, long long n, long long row_bytes,
                           void* stream) {
  if (n < 1 || row_bytes < 1 ||
      (row_bytes + kTileBytes - 1) / kTileBytes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (access_width(row_bytes, table, out)) {
    case 16: {
      const cudaError_t err = allow_smem(
          reinterpret_cast<const void*>(gather_rows_tma_kernel),
          static_cast<int>(kStages * kTileBytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      launch(gather_rows_tma_kernel, kTmaThreads, kStages, table, sorted_idx,
             out, n, row_bytes, s);
      break;
    }
    case 8:
      launch(gather_rows_vec_kernel<uint2>, kCopyThreads, 1, table,
             sorted_idx, out, n, row_bytes, s);
      break;
    case 4:
      launch(gather_rows_vec_kernel<unsigned int>, kCopyThreads, 1, table,
             sorted_idx, out, n, row_bytes, s);
      break;
    case 2:
      launch(gather_rows_vec_kernel<unsigned short>, kCopyThreads, 1, table,
             sorted_idx, out, n, row_bytes, s);
      break;
    default:
      launch(gather_rows_vec_kernel<unsigned char>, kCopyThreads, 1, table,
             sorted_idx, out, n, row_bytes, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
