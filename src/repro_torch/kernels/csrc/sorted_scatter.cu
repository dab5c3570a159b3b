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
// once, and writes the distinct rows. A CUDA grid has no order, so every
// write is owned by one block.
//
// First, for both modes, scatter_plan_kernel (one block) reads the indices
// once: their range and order, which the wrapper checks after its one host
// sync, an int32 copy of int64 indices, and for "add" the plan of the runs
// (see kernel.py's SpanPlan): each run of at most `span` slots (short), and
// each longer run with its spans -- the run cut into pieces of `span` slots
// aligned to its first slot. Two block-wide scans over each tile of slots
// give every slot its run's first slot and every item its position in the
// plan's lists: no atomics, no second sync. The wrapper reads the counts in
// that sync and sizes each launch's grid and the spans' workspace exactly.
//
// "set": only the block of a run's LAST slot (sorted_idx[i] !=
// sorted_idx[i+1], or i = n-1) writes; it copies the winning row with the
// widest aligned access.
//
// "add" casts each value to the accumulator type promote(float32, T) --
// float32, or float64 for a float64 table -- adds the table row in that
// precision and rounds once to the table's type T (an int32 table
// truncates toward zero): the reference's promoted-precision rule. The
// values may have another type V than the table (float32 gradients into a
// bf16 table). A short run is one block per 1024 columns that sums the
// run's rows in slot order, adds the table row and rounds (the one-pass
// route, scatter_add_runs_kernel). A long run -- a hot token's gradient,
// thousands of rows -- would make such a block walk thousands of rows one
// after another, so it takes the span route: one block per (span, 1024
// columns) sums its span's rows in slot order into a workspace row of the
// accumulator type (scatter_add_span_kernel), and then one block per (run,
// 1024 columns) folds the run's spans in span order, adds the table row and
// rounds once (scatter_add_fold_kernel). The partition depends only on the
// indices and `span`, so a call gives the same bits every time.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>

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

// ---------------------------------------------------------------- the plan

// One block of 1024 threads, 8 consecutive slots each: the fastest of
// 256 to 1024 threads by 8 to 32 slots tried (more slots spill registers).
constexpr int kPlanThreads = 1024;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPlanSlots = 8;  // consecutive slots of a thread in a tile
constexpr int kPlanTile = kPlanThreads * kPlanSlots;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPlanWarps == 32, "block_scan's second level is one warp");

// The plan's lists, each int32 (kernel.py's SpanPlan, in this order).
struct Plan {
  int* short_first;  // short run j: slots short_first[j] .. short_last[j],
  int* short_last;   // table row short_row[j]
  int* short_row;
  int* long_first;   // long run m: slots long_first[m] .. long_last[m],
  int* long_last;    // its spans long_span0[m] .. + ceil(length / span) - 1,
  int* long_span0;   // table row long_row[m]
  int* long_row;
  int* span_first;   // span k: slots span_first[k] .. span_last[k]
  int* span_last;
  long long cap_long, cap_span;  // lengths of the long and span lists
};

// Counts of a tile's items: short-run ends, long-run starts, span starts.
struct Counts {
  int s, l, k;
};

__device__ __forceinline__ Counts operator+(Counts a, Counts b) {
  return {a.s + b.s, a.l + b.l, a.k + b.k};
}
__device__ __forceinline__ int combine(int a, int b) { return max(a, b); }
__device__ __forceinline__ Counts combine(Counts a, Counts b) { return a + b; }
__device__ __forceinline__ int shfl_up(int x, int off) {
  return __shfl_up_sync(kFull, x, off);
}
__device__ __forceinline__ Counts shfl_up(Counts x, int off) {
  return {shfl_up(x.s, off), shfl_up(x.l, off), shfl_up(x.k, off)};
}

// Exclusive scan of x over the block's threads in thread order, by
// combine() (max for an int, + for Counts), from `identity`; *total gets
// the combination of all threads' x. `parts` is kPlanWarps of shared
// memory. Every thread of the block calls it.
template <typename X>
__device__ X block_scan(X x, X identity, X* parts, X* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  X inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const X y = shfl_up(inc, off);
    if (lane >= off) inc = combine(y, inc);
  }
  if (lane == 31) parts[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    X w = parts[lane];  // kPlanWarps == 32
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const X y = shfl_up(w, off);
      if (lane >= off) w = combine(y, w);
    }
    parts[lane] = w;
  }
  __syncthreads();
  X before = shfl_up(inc, 1);
  if (lane == 0) before = identity;
  const X out = warp == 0 ? before : combine(parts[warp - 1], before);
  *total = parts[kPlanWarps - 1];
  __syncthreads();  // parts is reused by the next scan
  return out;
}

// stats: [min index, max index, 1 if some index is below its predecessor,
// short runs, long runs, spans]. idx32 (or null) gets the int32 copy;
// plan.short_first null: indices only, no plan ("set").
template <typename I>
__global__ void __launch_bounds__(kPlanThreads)
scatter_plan_kernel(const I* __restrict__ idx, int* __restrict__ idx32,
                    long long n, int span, Plan plan,
                    long long* __restrict__ stats) {
  __shared__ int first_parts[kPlanWarps];
  __shared__ Counts count_parts[kPlanWarps];
  __shared__ long long lo_parts[kPlanWarps], hi_parts[kPlanWarps];
  __shared__ int unsorted_parts[kPlanWarps];
  long long lo = LLONG_MAX, hi = LLONG_MIN;
  int unsorted = 0;
  int first_carry = 0;          // the last run start before this tile
  Counts carry = {0, 0, 0};     // the items before this tile
  for (long long base = 0; base < n; base += kPlanTile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kPlanSlots;
    // v[q + 1] is slot i0 + q; v[0] and v[kPlanSlots + 1] its neighbours.
    I v[kPlanSlots + 2];
#pragma unroll
    for (int q = 0; q < kPlanSlots + 2; ++q) {
      const long long i = i0 - 1 + q;
      v[q] = (i >= 0 && i < n) ? idx[i] : I(0);
    }
    int last_start = -1;
#pragma unroll
    for (int q = 0; q < kPlanSlots; ++q) {
      const long long i = i0 + q;
      if (i >= n) break;
      const long long x = v[q + 1];
      lo = min(lo, x);
      hi = max(hi, x);
      if (i > 0 && v[q + 1] < v[q]) unsorted = 1;
      if (idx32 != nullptr) idx32[i] = static_cast<int>(x);
      if (i == 0 || v[q] != v[q + 1]) last_start = static_cast<int>(i);
    }
    if (plan.short_first == nullptr) continue;  // uniform over the block

    // Each slot's run start: the last start at or before it.
    int first_total;
    int first = max(first_carry,
                    block_scan(last_start, -1, first_parts, &first_total));
    first_carry = max(first_carry, first_total);
    unsigned is_short_end = 0, is_long_start = 0, is_long_end = 0,
             is_span_start = 0, is_span_full = 0;
    int firsts[kPlanSlots];
    Counts mine = {0, 0, 0};
#pragma unroll
    for (int q = 0; q < kPlanSlots; ++q) {
      const long long i = i0 + q;
      if (i >= n) break;
      if (i == 0 || v[q] != v[q + 1]) first = static_cast<int>(i);
      firsts[q] = first;
      const long long off = i - first;
      const bool end = i + 1 == n || v[q + 2] != v[q + 1];
      // A run is long when its slot `span` past its start holds its row.
      const bool long_start =
          off == 0 && i + span < n && idx[i + span] == v[q + 1];
      const bool span_start =
          off % span == 0 && (off > 0 || long_start);
      // A span's end is written by its start where the run fills all of
      // its `span` slots, else (the run's last span) by the run's end.
      if (span_start && i + span - 1 < n && idx[i + span - 1] == v[q + 1])
        is_span_full |= 1u << q;
      const unsigned bit = 1u << q;
      if (end && off < span) { is_short_end |= bit; ++mine.s; }
      if (end && off >= span) is_long_end |= bit;
      if (long_start) { is_long_start |= bit; ++mine.l; }
      if (span_start) { is_span_start |= bit; ++mine.k; }
    }
    Counts tile_total;
    const Counts before = carry + block_scan(mine, Counts{0, 0, 0},
                                             count_parts, &tile_total);
    carry = carry + tile_total;
    // m counts the long runs started so far, k the spans: the current
    // long run is m - 1, its latest span k - 1.
    int j = before.s, m = before.l, k = before.k;
#pragma unroll
    for (int q = 0; q < kPlanSlots; ++q) {
      const int i = static_cast<int>(i0 + q);
      const int row = static_cast<int>(v[q + 1]);
      const unsigned bit = 1u << q;
      if (is_long_start & bit) {
        if (m < plan.cap_long) {
          plan.long_first[m] = i;
          plan.long_span0[m] = k;
          plan.long_row[m] = row;
        }
        ++m;
      }
      if (is_span_start & bit) {
        if (k < plan.cap_span) {
          plan.span_first[k] = i;
          if (is_span_full & bit) plan.span_last[k] = i + span - 1;
        }
        ++k;
      }
      if (is_short_end & bit) {
        plan.short_first[j] = firsts[q];
        plan.short_last[j] = i;
        plan.short_row[j] = row;
        ++j;
      }
      if (is_long_end & bit) {
        if (m >= 1 && m - 1 < plan.cap_long) plan.long_last[m - 1] = i;
        if ((i - firsts[q]) % span != span - 1 && k >= 1 &&
            k - 1 < plan.cap_span)
          plan.span_last[k - 1] = i;
      }
    }
  }

  // The block's min, max and order flag.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
    unsorted |= __shfl_xor_sync(kFull, unsorted, off);
  }
  if (lane == 0) {
    lo_parts[warp] = lo;
    hi_parts[warp] = hi;
    unsorted_parts[warp] = unsorted;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPlanWarps; ++w) {
      lo = min(lo, lo_parts[w]);
      hi = max(hi, hi_parts[w]);
      unsorted |= unsorted_parts[w];
    }
    stats[0] = lo;
    stats[1] = hi;
    stats[2] = unsorted;
    stats[3] = carry.s;
    stats[4] = carry.l;
    stats[5] = carry.k;
  }
}

// ------------------------------------------------------------------- add

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
// Rows whose loads are in flight together: many in a span (64 rows), few
// in a short run (most hold one to three rows), where registers would
// only cost occupancy: with eight the one-pass kernel is register-bound
// and slower (PERF.md).
constexpr int kSpanUnroll = 16;
constexpr int kRunsUnroll = 2;
constexpr int kAddMinBlocks = 2;  // __launch_bounds__' blocks per SM

// acc[q] += rows [a, b) of `rows` at this thread's columns, one row after
// another in slot order; the loads of `Unroll` rows are issued together.
template <int Unroll, typename Acc, typename V>
__device__ __forceinline__ void sum_rows(Acc (&acc)[kAddCols],
                                         const V* __restrict__ rows,
                                         long long a, long long b,
                                         long long d) {
  const long long c0 =
      static_cast<long long>(blockIdx.y) * kAddBlockCols + threadIdx.x;
  long long k = a;
  for (; k + Unroll <= b; k += Unroll) {
    V v[Unroll][kAddCols];
#pragma unroll
    for (int u = 0; u < Unroll; ++u)
#pragma unroll
      for (int q = 0; q < kAddCols; ++q) {
        const long long c = c0 + q * kAddThreads;
        if (c < d) v[u][q] = rows[(k + u) * d + c];
      }
#pragma unroll
    for (int u = 0; u < Unroll; ++u)
#pragma unroll
      for (int q = 0; q < kAddCols; ++q)
        if (c0 + q * kAddThreads < d) acc[q] += cast_acc<Acc>(v[u][q]);
  }
  for (; k < b; ++k) {
#pragma unroll
    for (int q = 0; q < kAddCols; ++q) {
      const long long c = c0 + q * kAddThreads;
      if (c < d) acc[q] += cast_acc<Acc>(rows[k * d + c]);
    }
  }
}

// The table row at this thread's columns, read before the sum (`base`),
// and written back as round(base + acc).
template <typename T>
__device__ __forceinline__ void load_row(T (&base)[kAddCols],
                                         const T* __restrict__ src,
                                         long long d) {
  const long long c0 =
      static_cast<long long>(blockIdx.y) * kAddBlockCols + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) {
    const long long c = c0 + q * kAddThreads;
    if (c < d) base[q] = src[c];
  }
}
template <typename T, typename Acc>
__device__ __forceinline__ void store_row(T* __restrict__ dst,
                                          const T (&base)[kAddCols],
                                          const Acc (&acc)[kAddCols],
                                          long long d) {
  const long long c0 =
      static_cast<long long>(blockIdx.y) * kAddBlockCols + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) {
    const long long c = c0 + q * kAddThreads;
    if (c < d) store(dst + c, cast_acc<Acc>(base[q]) + acc[q]);
  }
}

// One-pass route: block (j, column tile) writes short run j.
template <typename T, typename V>
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
scatter_add_runs_kernel(T* __restrict__ table, const V* __restrict__ svals,
                        const int* __restrict__ run_first,
                        const int* __restrict__ run_last,
                        const int* __restrict__ run_row, long long d) {
  using Acc = typename AccOf<T>::type;
  const long long a = run_first[blockIdx.x], b = run_last[blockIdx.x];
  T* row = table + static_cast<long long>(run_row[blockIdx.x]) * d;
  T base[kAddCols];
  load_row(base, row, d);
  Acc acc[kAddCols];
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) acc[q] = Acc(0);
  sum_rows<kRunsUnroll>(acc, svals, a, b + 1, d);
  store_row(row, base, acc, d);
}

// Span route, first pass: block (k, column tile) sums span k into
// workspace row k.
template <typename Acc, typename V>
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
scatter_add_span_kernel(Acc* __restrict__ ws, const V* __restrict__ svals,
                        const int* __restrict__ span_first,
                        const int* __restrict__ span_last, long long d) {
  const long long k = blockIdx.x;
  const long long a = span_first[k], b = span_last[k] + 1;
  Acc acc[kAddCols];
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) acc[q] = Acc(0);
  sum_rows<kSpanUnroll>(acc, svals, a, b, d);
  const long long c0 =
      static_cast<long long>(blockIdx.y) * kAddBlockCols + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) {
    const long long c = c0 + q * kAddThreads;
    if (c < d) ws[k * d + c] = acc[q];
  }
}

// Span route, second pass: block (m, column tile) folds long run m's spans
// in span order and writes the run.
template <typename T>
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
scatter_add_fold_kernel(T* __restrict__ table,
                        const typename AccOf<T>::type* __restrict__ ws,
                        const int* __restrict__ long_first,
                        const int* __restrict__ long_last,
                        const int* __restrict__ long_span0,
                        const int* __restrict__ long_row, long long d,
                        int span) {
  using Acc = typename AccOf<T>::type;
  const long long m = blockIdx.x;
  const long long f = long_first[m], e = long_last[m], k0 = long_span0[m];
  T* row = table + static_cast<long long>(long_row[m]) * d;
  T base[kAddCols];
  load_row(base, row, d);
  Acc acc[kAddCols];
#pragma unroll
  for (int q = 0; q < kAddCols; ++q) acc[q] = Acc(0);
  sum_rows<kSpanUnroll>(acc, ws, k0, k0 + (e - f + span) / span, d);
  store_row(row, base, acc, d);
}

struct AddArgs {
  void* table;
  const void* svals;
  long long d;
  int span;
  const int *short_first, *short_last, *short_row, *long_first, *long_last,
      *long_span0, *long_row, *span_first, *span_last;
  long long n_short, n_long, n_span;
  void* ws;
  cudaStream_t stream;
};

template <typename T, typename V>
static void launch_add(const AddArgs& a) {
  using Acc = typename AccOf<T>::type;
  const unsigned tiles =
      static_cast<unsigned>((a.d + kAddBlockCols - 1) / kAddBlockCols);
  const V* svals = static_cast<const V*>(a.svals);
  T* table = static_cast<T*>(a.table);
  Acc* ws = static_cast<Acc*>(a.ws);
  if (a.n_span > 0)
    scatter_add_span_kernel<Acc, V>
        <<<dim3(static_cast<unsigned>(a.n_span), tiles), kAddThreads, 0,
            a.stream>>>(ws, svals, a.span_first, a.span_last, a.d);
  if (a.n_short > 0)
    scatter_add_runs_kernel<T, V>
        <<<dim3(static_cast<unsigned>(a.n_short), tiles), kAddThreads, 0,
            a.stream>>>(table, svals, a.short_first, a.short_last,
                        a.short_row, a.d);
  if (a.n_long > 0)
    scatter_add_fold_kernel<T>
        <<<dim3(static_cast<unsigned>(a.n_long), tiles), kAddThreads, 0,
            a.stream>>>(table, ws, a.long_first, a.long_last, a.long_span0,
                        a.long_row, a.d, a.span);
}

// Type codes: 0 float32, 1 bfloat16, 2 float16, 3 float64, 4 int32.
template <typename T>
static bool launch_add_values(int vtype, const AddArgs& a) {
  switch (vtype) {
    case 0: launch_add<T, float>(a); return true;
    case 1: launch_add<T, __nv_bfloat16>(a); return true;
    case 2: launch_add<T, __half>(a); return true;
    case 3: launch_add<T, double>(a); return true;
    case 4: launch_add<T, int>(a); return true;
    default: return false;
  }
}

template <typename V>
static void launch_set(void* table, const void* sidx, const void* svals,
                       long long n, long long row_bytes, cudaStream_t s) {
  scatter_set_kernel<V><<<static_cast<unsigned>(n), kCopyThreads, 0, s>>>(
      static_cast<char*>(table), static_cast<const int*>(sidx),
      static_cast<const char*>(svals), n, row_bytes);
}

// idx: (n,) int32 (idx_is_64 = 0) or int64; idx32: (n,) int32, written
// for int64 indices (null for int32). The nine plan lists are int32 of
// lengths n x 3, cap_long x 4, cap_span x 2 (short_first null: no plan);
// stats: 6 int64. 1 <= n < 2^31, span >= 1.
extern "C" int scatter_plan(const void* idx, int idx_is_64, void* idx32,
                            long long n, int span, void* short_first,
                            void* short_last, void* short_row,
                            void* long_first, void* long_last,
                            void* long_span0, void* long_row,
                            void* span_first, void* span_last,
                            long long cap_long, long long cap_span,
                            void* stats, void* stream) {
  if (n < 1 || span < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = {static_cast<int*>(short_first),
                     static_cast<int*>(short_last),
                     static_cast<int*>(short_row),
                     static_cast<int*>(long_first),
                     static_cast<int*>(long_last),
                     static_cast<int*>(long_span0),
                     static_cast<int*>(long_row),
                     static_cast<int*>(span_first),
                     static_cast<int*>(span_last), cap_long, cap_span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_64)
    scatter_plan_kernel<long long><<<1, kPlanThreads, 0, s>>>(
        static_cast<const long long*>(idx), static_cast<int*>(idx32), n,
        span, plan, static_cast<long long*>(stats));
  else
    scatter_plan_kernel<int><<<1, kPlanThreads, 0, s>>>(
        static_cast<const int*>(idx), nullptr, n, span, plan,
        static_cast<long long*>(stats));
  return static_cast<int>(cudaGetLastError());
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
// (n, d) of vtype, in sorted order; the plan's lists as scatter_plan wrote
// them, with its counts; ws: (n_span, d) of the accumulator type (float64
// for a float64 table, else float32). d < 2^16 * 1024.
extern "C" int scatter_add_runs(void* table, const void* svals, long long d,
                                int ttype, int vtype, int span,
                                const void* short_first,
                                const void* short_last, const void* short_row,
                                long long n_short, const void* long_first,
                                const void* long_last, const void* long_span0,
                                const void* long_row, long long n_long,
                                const void* span_first, const void* span_last,
                                long long n_span, void* ws, void* stream) {
  const AddArgs a = {table, svals, d, span,
                     static_cast<const int*>(short_first),
                     static_cast<const int*>(short_last),
                     static_cast<const int*>(short_row),
                     static_cast<const int*>(long_first),
                     static_cast<const int*>(long_last),
                     static_cast<const int*>(long_span0),
                     static_cast<const int*>(long_row),
                     static_cast<const int*>(span_first),
                     static_cast<const int*>(span_last), n_short, n_long,
                     n_span, ws, static_cast<cudaStream_t>(stream)};
  bool ok;
  switch (ttype) {
    case 0: ok = launch_add_values<float>(vtype, a); break;
    case 1: ok = launch_add_values<__nv_bfloat16>(vtype, a); break;
    case 2: ok = launch_add_values<__half>(vtype, a); break;
    case 3: ok = launch_add_values<double>(vtype, a); break;
    case 4: ok = launch_add_values<int>(vtype, a); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
