// Sorted row scatter, in place: for each run of equal sorted indices, one
// write to table[row] -- the run's last value ("set"), or table[row] plus
// the run's sum ("add").
//
// Replaces the TPU kernel src/repro/kernels/sorted_scatter/kernel.py
// (scatter_rows) together with the run folding of
// src/repro/kernels/sorted_scatter/coalesce.py (coalesce_add_runs). On the
// TPU the grid runs in order, a run overwrites one VMEM block, and only the
// block's final value is flushed.
//
// Bound on the H100: bytes. "set" reads one value row per distinct row and
// writes it; "add" reads every value row once and each distinct table row
// once, and writes the distinct rows. Design: a CUDA grid has no order, so
// only the block of a run's LAST slot (sorted_idx[i] != sorted_idx[i+1], or
// i = n-1) writes; every other block returns after reading two indices.
// "set" copies the winning row with the widest aligned access. "add" finds
// the run's first slot by binary search (the indices are sorted), casts
// each value to the accumulator type promote(float32, T) -- float32, or
// float64 for a float64 table -- sums the run's rows in arrival order, adds
// the table row in that precision and rounds once to the table's type T
// (an int32 table truncates toward zero) -- the reference's promoted-
// precision rule. The values may have another type V than the table
// (float32 gradients into a bf16 table). No atomics, so the result is the
// same on every run. A long run (a hot token's gradient) is summed by
// ceil(d / 1024) blocks, each owning 1024 columns, four per thread.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

__device__ __forceinline__ bool is_run_end(const int* __restrict__ sidx,
                                           long long i, long long n) {
  return i + 1 == n || sidx[i + 1] != sidx[i];
}

template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
scatter_set_kernel(char* __restrict__ table, const int* __restrict__ sidx,
                   const char* __restrict__ svals, long long n,
                   long long row_bytes) {
  const long long i = blockIdx.x;
  if (!is_run_end(sidx, i, n)) return;
  const long long row = sidx[i];
  copy_row<V>(table + row * row_bytes, svals + i * row_bytes, row_bytes);
}

// The accumulator of a table of type T: promote(float32, T).
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// A value of type V cast to the accumulator A, as ``astype(A)`` does.
template <typename A> __device__ __forceinline__ A cast_acc(float x) {
  return A(x);
}
template <typename A> __device__ __forceinline__ A cast_acc(double x) {
  return A(x);
}
template <typename A> __device__ __forceinline__ A cast_acc(int x) {
  return A(x);
}
template <typename A> __device__ __forceinline__ A cast_acc(__nv_bfloat16 x) {
  return A(__bfloat162float(x));
}
template <typename A> __device__ __forceinline__ A cast_acc(__half x) {
  return A(__half2float(x));
}

// The accumulator rounded once to the table's type.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(int* p, float v) {
  *p = __float2int_rz(v);
}

constexpr int kAddThreads = 256;
constexpr int kAddCols = 4;  // columns per thread
constexpr int kAddBlockCols = kAddThreads * kAddCols;

template <typename T, typename V>
__global__ void __launch_bounds__(kAddThreads)
scatter_add_kernel(T* __restrict__ table, const int* __restrict__ sidx,
                   const V* __restrict__ svals, long long n, long long d) {
  using Acc = typename AccOf<T>::type;
  const long long i = blockIdx.x;
  if (!is_run_end(sidx, i, n)) return;
  const int row = sidx[i];
  long long lo = 0, hi = i;  // first slot of the run: lower bound of row
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sidx[mid] < row) lo = mid + 1; else hi = mid;
  }
  const long long c0 =
      static_cast<long long>(blockIdx.y) * kAddBlockCols + threadIdx.x;
  Acc acc[kAddCols];
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) acc[q] = Acc(0);
  for (long long k = lo; k <= i; ++k) {
    const V* src = svals + k * d;
#pragma unroll
    for (int q = 0; q < kAddCols; ++q) {
      const long long c = c0 + q * kAddThreads;
      if (c < d) acc[q] += cast_acc<Acc>(src[c]);
    }
  }
  T* dst = table + static_cast<long long>(row) * d;
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) {
    const long long c = c0 + q * kAddThreads;
    if (c < d) store(dst + c, cast_acc<Acc>(dst[c]) + acc[q]);
  }
}

template <typename V>
static void launch_set(void* table, const void* sidx, const void* svals,
                       long long n, long long row_bytes, cudaStream_t s) {
  scatter_set_kernel<V><<<static_cast<unsigned>(n), kCopyThreads, 0, s>>>(
      static_cast<char*>(table), static_cast<const int*>(sidx),
      static_cast<const char*>(svals), n, row_bytes);
}

template <typename T, typename V>
static void launch_add(void* table, const void* sidx, const void* svals,
                       long long n, long long d, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((d + kAddBlockCols - 1) / kAddBlockCols));
  scatter_add_kernel<T, V><<<grid, kAddThreads, 0, s>>>(
      static_cast<T*>(table), static_cast<const int*>(sidx),
      static_cast<const V*>(svals), n, d);
}

// Type codes: 0 float32, 1 bfloat16, 2 float16, 3 float64, 4 int32.
template <typename T>
static bool launch_add_values(int vtype, void* table, const void* sidx,
                              const void* svals, long long n, long long d,
                              cudaStream_t s) {
  switch (vtype) {
    case 0: launch_add<T, float>(table, sidx, svals, n, d, s); return true;
    case 1: launch_add<T, __nv_bfloat16>(table, sidx, svals, n, d, s); return true;
    case 2: launch_add<T, __half>(table, sidx, svals, n, d, s); return true;
    case 3: launch_add<T, double>(table, sidx, svals, n, d, s); return true;
    case 4: launch_add<T, int>(table, sidx, svals, n, d, s); return true;
    default: return false;
  }
}

// table: (R, row_bytes) bytes, written in place; sorted_idx: (n,) int32,
// sorted, in [0, R); svals: (n, row_bytes) bytes. 1 <= n < 2^31.
extern "C" int scatter_set_rows(void* table, const void* sorted_idx,
                                const void* svals, long long n,
                                long long row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (access_width(row_bytes, table, svals)) {
    case 16: launch_set<uint4>(table, sorted_idx, svals, n, row_bytes, s); break;
    case 8: launch_set<uint2>(table, sorted_idx, svals, n, row_bytes, s); break;
    case 4: launch_set<unsigned int>(table, sorted_idx, svals, n, row_bytes, s); break;
    case 2: launch_set<unsigned short>(table, sorted_idx, svals, n, row_bytes, s); break;
    default: launch_set<unsigned char>(table, sorted_idx, svals, n, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ttype, vtype: type codes of the table and the values (see
// launch_add_values). table: (R, d) of ttype, written in place; svals:
// (n, d) of vtype. d < 2^16 * 1024.
extern "C" int scatter_add_runs(void* table, const void* sorted_idx,
                                const void* svals, long long n, long long d,
                                int ttype, int vtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  switch (ttype) {
    case 0: ok = launch_add_values<float>(vtype, table, sorted_idx, svals, n, d, s); break;
    case 1: ok = launch_add_values<__nv_bfloat16>(vtype, table, sorted_idx, svals, n, d, s); break;
    case 2: ok = launch_add_values<__half>(vtype, table, sorted_idx, svals, n, d, s); break;
    case 3: ok = launch_add_values<double>(vtype, table, sorted_idx, svals, n, d, s); break;
    case 4: ok = launch_add_values<int>(vtype, table, sorted_idx, svals, n, d, s); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
