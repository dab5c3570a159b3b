// Cache probe: the cache engine's tag/LRU pipeline over a batch of line
// ids -- per beat, the tag compare, the LRU decision and the metadata
// update; returns each beat's hit and way and the new tags, valid bits,
// ages and clock.
//
// Replaces the TPU kernel src/repro/kernels/cache_lookup/kernel.py
// (cache_probe), which keeps the whole tag store in VMEM and walks all N
// beats in arrival order with a fori_loop, comparing the ways on vector
// lanes.
//
// Bound on the H100: neither bytes nor operations but the longest chain of
// dependent beats. The state at the Table I maximum (32768 ways x 3 int32,
// 384 KiB) does not fit one block's shared memory, and one walker over all
// N beats would leave the card idle. But beat i always stamps age
// clock0 + i + 1 and touches only its own set, so the sets are
// independent. Design: one warp per set, the ways on lanes (ways <= 32).
// The warp holds its set's tags, valid bits and ages in registers, walks
// that set's beats in arrival order -- __ballot_sync finds the match (the
// lowest matching way wins, as jnp.argmax does), __reduce_min_sync the
// oldest age and a second ballot its lowest way (the lowest way among equal
// ages, as jnp.argmin does), the owning lane updates its registers -- and
// writes the state back once. The wrapper groups the beats by set on the
// device (a stable sort of line % sets and per-set start offsets, no host
// sync); the warp reads its beats 32 at a time, one per lane, each lane
// computing its beat's tag once, and hands them round with __shfl_sync.
// The line ids of the next group and the beats of the group after it are
// loaded while a group runs. The longest per-set chain sets the time: a hot
// set is walked by one warp, and each beat's chain is two shuffles, two
// ballots and one warp reduction.
#include <limits.h>

#include "common.cuh"

constexpr int kProbeWarps = 4;  // sets per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kProbeWarps * 32)
cache_probe_kernel(const int* __restrict__ line_ids,
                   const long long* __restrict__ order,
                   const int* __restrict__ set_start,
                   const int* __restrict__ tags_in,
                   const int* __restrict__ valid_in,
                   const int* __restrict__ age_in,
                   const int* __restrict__ clock_in, int* __restrict__ hits,
                   int* __restrict__ ways_out, int* __restrict__ tags_out,
                   int* __restrict__ valid_out, int* __restrict__ age_out,
                   int* __restrict__ clock_out, int sets, int ways, int n) {
  const int lane = threadIdx.x & 31;
  const long long set =
      static_cast<long long>(blockIdx.x) * kProbeWarps + (threadIdx.x >> 5);
  const unsigned clock0 = static_cast<unsigned>(clock_in[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    clock_out[0] = static_cast<int>(clock0 + static_cast<unsigned>(n));
  if (set >= sets) return;  // the whole warp leaves together
  const bool live = lane < ways;
  const long long slot = set * ways + lane;
  int tag = live ? tags_in[slot] : 0;
  int valid = live ? valid_in[slot] : 0;
  // Lanes past `ways` hold INT_MAX and a higher lane than every live one,
  // so the lowest lane of the oldest age is always a live way.
  int age = live ? age_in[slot] : INT_MAX;
  const int lo = set_start[set], hi = set_start[set + 1];
  // This lane's beat of the current group, and of the next; the line id of
  // the current group's beat. Loaded one and two groups ahead.
  int beat = lo + lane < hi ? static_cast<int>(order[lo + lane]) : 0;
  int line = lo + lane < hi ? line_ids[beat] : 0;
  int next_beat =
      lo + 32 + lane < hi ? static_cast<int>(order[lo + 32 + lane]) : 0;
  for (int base = lo; base < hi; base += 32) {
    const int count = min(32, hi - base);
    const int my_beat = beat, my_tag = line / sets;
    beat = next_beat;
    line = base + 32 + lane < hi ? line_ids[beat] : 0;
    next_beat = base + 64 + lane < hi
                    ? static_cast<int>(order[base + 64 + lane]) : 0;
    int my_hit = 0, my_way = 0;
    for (int b = 0; b < count; ++b) {
      const int stamp_beat = __shfl_sync(kFull, my_beat, b);
      const int t = __shfl_sync(kFull, my_tag, b);
      const unsigned match = __ballot_sync(kFull, live && valid && tag == t);
      const int oldest = __reduce_min_sync(kFull, age);
      const unsigned lru = __ballot_sync(kFull, age == oldest);
      const int way = __ffs(match != 0u ? match : lru) - 1;
      if (lane == way) {
        tag = t;
        valid = 1;
        age = static_cast<int>(clock0 + static_cast<unsigned>(stamp_beat) +
                               1u);
      }
      if (lane == b) {
        my_hit = match != 0u;
        my_way = way;
      }
    }
    if (lane < count) {
      hits[my_beat] = my_hit;
      ways_out[my_beat] = my_way;
    }
  }
  if (live) {
    tags_out[slot] = tag;
    valid_out[slot] = valid;
    age_out[slot] = age;
  }
}

// line_ids: (n,) int32, >= 0; order: (n,) int64, the beats stably sorted by
// line % sets; set_start: (sets + 1,) int32, set s's beats are
// order[set_start[s] : set_start[s + 1]]; tags/valid/age: (sets, ways)
// int32, ways <= 32; clock: (1,) int32. Outputs: hits, ways (n,) int32, the
// new state of the same shapes. 1 <= n < 2^31.
extern "C" int cache_probe(const void* line_ids, const void* order,
                           const void* set_start, const void* tags,
                           const void* valid, const void* age,
                           const void* clock, void* hits, void* ways_out,
                           void* tags_out, void* valid_out, void* age_out,
                           void* clock_out, int sets, int ways, int n,
                           void* stream) {
  if (sets < 1 || ways < 1 || ways > 32 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(sets) + kProbeWarps - 1) /
                            kProbeWarps);
  cache_probe_kernel<<<grid, kProbeWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(line_ids), static_cast<const long long*>(order),
      static_cast<const int*>(set_start), static_cast<const int*>(tags),
      static_cast<const int*>(valid), static_cast<const int*>(age),
      static_cast<const int*>(clock), static_cast<int*>(hits),
      static_cast<int*>(ways_out), static_cast<int*>(tags_out),
      static_cast<int*>(valid_out), static_cast<int*>(age_out),
      static_cast<int*>(clock_out), sets, ways, n);
  return static_cast<int>(cudaGetLastError());
}

// Read/write probe: the set-parallel cache engine's tag pipeline over a
// mixed read/write trace -- B5's walk with each way's dirty bit and each
// beat's write flag added. Per beat it reports whether the miss evicts a
// valid dirty way (a victim write-back) and the tag of the way it
// replaces, both read before the update.
//
// Replaces no Pallas kernel: the reference runs this walk as an XLA
// lax.scan over per-set lanes (_tag_round in
// src/repro/core/trace_engine.py), whose step is copied here exactly:
//   evict      = !hit && valid[way] && dirty[way]
//   keep_dirty = hit && dirty[way] && !is_write
//   dirty[way] = write_back ? (is_write || keep_dirty) : keep_dirty
//
// Given the backing table's row count, the walk also resolves where every
// value comes from, so that the engine moves winner rows only. A source
// index is a beat's payload (< n), the pre-trace content of way `flat`
// (n + flat) or, as -1, the table's original row. It rests on the set
// partition: beat, victim and fill of line L touch only set L % sets, so
// the value a beat observes is the last write to its line at or before it
// (a trace write, else the latest pre-trace dirty way holding the line),
// and the warp that walks set s is the only one that reads or writes
// entries of lines = s (mod sets) in a per-line array. Outputs:
//   src[b]       the value beat b observes (a write its own payload);
//   flush_src[b] the value its dirty victim writes back, -1 if none;
//   last[slot]   the last beat that touched the way, -1 if none;
//   row_src[r]   the value of the latest event writing table row r (a
//                victim flush, or under write-through a write; at one beat
//                the flush comes first), -1 if none. A victim line outside
//                [0, rows) -- only a pre-trace dirty way can hold one --
//                is clipped into it, as the reference clips it.
//
// Bound on the H100: like B5, the longest chain of dependent beats of one
// set. Design: B5's -- one warp per set, the ways on lanes, the beats
// grouped by set on the device and read 32 at a time, the write flag in
// bit 31 of the shuffled beat index (n < 2^31). What does not feed the
// next beat's decision is off the chain: the valid and valid-dirty bits
// are warp-uniform masks that every lane updates alike (no ballot), and
// the owning lane leaves the victim's tag and value source in a per-warp
// shared-memory slot that the beat's lane reads after the group (no
// shuffle). Per beat the chain is one ballot of the tag compare and the
// LRU's warp reduction and ballot. A full group of 32 beats is unrolled, so
// each beat's shuffles and records overlap the chain of the beat before,
// and the write policy is a template parameter: as a run-time flag, the
// compiler scheduled one policy's walk much slower than the other's. Each
// lane keeps its way's value source in a register: a write sets it on
// every valid way holding the line (the last write to the line, also
// where an initial state holds one line twice), so an eviction hands it
// over as flush_src. The served sources
// come after each group: one load of the per-line last write per beat,
// issued before the group's walk, and __match_any_sync for the writes
// earlier in the group; the latest write of each line then stores it.
// Row events are integer atomicMax of (2 * beat + kind + 1) << 32 | source
// on the row, an order-free reduction that also takes the clipped rows,
// which other sets share; a second pass turns each key into its source.
template <bool kWriteBack>
__global__ void __launch_bounds__(kProbeWarps * 32)
cache_probe_rw_kernel(const int* __restrict__ line_ids,
                      const unsigned char* __restrict__ is_write,
                      const long long* __restrict__ order,
                      const int* __restrict__ set_start,
                      const int* __restrict__ tags_in,
                      const int* __restrict__ valid_in,
                      const int* __restrict__ age_in,
                      const int* __restrict__ dirty_in,
                      const int* __restrict__ clock_in,
                      int* __restrict__ hits, int* __restrict__ ways_out,
                      int* __restrict__ evict_out,
                      int* __restrict__ vic_tag_out,
                      int* __restrict__ tags_out, int* __restrict__ valid_out,
                      int* __restrict__ age_out, int* __restrict__ dirty_out,
                      int* __restrict__ clock_out,
                      long long* __restrict__ src_out,
                      long long* __restrict__ flush_src_out,
                      long long* __restrict__ last_out,
                      unsigned long long* __restrict__ row_key,
                      long long* __restrict__ last_write, int sets, int ways,
                      int n, int rows) {
  __shared__ int s_vic[kProbeWarps][32];
  __shared__ long long s_flush[kProbeWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long set =
      static_cast<long long>(blockIdx.x) * kProbeWarps + warp;
  const unsigned clock0 = static_cast<unsigned>(clock_in[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    clock_out[0] = static_cast<int>(clock0 + static_cast<unsigned>(n));
  if (set >= sets) return;  // the whole warp leaves together
  const bool live = lane < ways;
  const long long slot = set * ways + lane;
  int tag = live ? tags_in[slot] : 0;
  int age = live ? age_in[slot] : INT_MAX;  // as in cache_probe_kernel
  // The valid and dirty words as given, for the outputs of untouched
  // ways; the decisions read the warp-uniform masks.
  int valid_word = live ? valid_in[slot] : 0;
  int dirty_word = live ? dirty_in[slot] : 0;
  unsigned valid = __ballot_sync(kFull, valid_word != 0);
  unsigned vdirty = __ballot_sync(kFull, valid_word != 0 && dirty_word != 0);
  // This way's value source: for a valid dirty way, the latest pre-trace
  // dirty way of its set that holds the same line.
  long long way_src = -1;
  int last_beat = -1;
  if ((vdirty >> lane) & 1u) {
    const unsigned same = __match_any_sync(vdirty, tag);
    way_src = n + (slot - lane) + (31 - __clz(same));
    const long long line = static_cast<long long>(tag) * sets + set;
    if (line >= 0 && line < rows) last_write[line] = way_src + 1;
  }
  __syncwarp();
  const int lo = set_start[set], hi = set_start[set + 1];
  int beat = lo + lane < hi ? static_cast<int>(order[lo + lane]) : 0;
  int line = lo + lane < hi ? line_ids[beat] : 0;
  int write = lo + lane < hi ? is_write[beat] : 0;
  int next_beat =
      lo + 32 + lane < hi ? static_cast<int>(order[lo + 32 + lane]) : 0;
  for (int base = lo; base < hi; base += 32) {
    const int count = min(32, hi - base);
    const bool mine = lane < count;
    const int my_beat = beat, my_line = line, my_tag = line / sets;
    const bool my_w = write != 0;
    const unsigned my_bw = static_cast<unsigned>(my_beat) |
                           (static_cast<unsigned>(my_w) << 31);
    // The per-line arrays are indexed only by an id in range: an id out of
    // range raises after the launch, and its outputs are dropped.
    const bool in_rows = mine && my_line >= 0 && my_line < rows;
    const long long seen = in_rows ? last_write[my_line] - 1 : -1;
    beat = next_beat;
    const bool more = base + 32 + lane < hi;
    line = more ? line_ids[beat] : 0;
    write = more ? is_write[beat] : 0;
    next_beat = base + 64 + lane < hi
                    ? static_cast<int>(order[base + 64 + lane]) : 0;
    int my_hit = 0, my_way = 0, my_evict = 0;
    // One beat of the walk; a full group is unrolled, so that each beat's
    // independent work overlaps the chain of the one before.
    auto step = [&](const int b) {
      const unsigned bw = __shfl_sync(kFull, my_bw, b);
      const int t = __shfl_sync(kFull, my_tag, b);
      const bool w = (bw >> 31) != 0u;
      const unsigned match = __ballot_sync(kFull, tag == t) & valid;
      const int oldest = __reduce_min_sync(kFull, age);
      const unsigned lru = __ballot_sync(kFull, age == oldest);
      const bool hit = match != 0u;
      const int way = __ffs(hit ? match : lru) - 1;
      const unsigned bit = 1u << way;
      const bool way_dirty = (vdirty & bit) != 0u;
      const bool dirty = (kWriteBack && w) || (hit && way_dirty && !w);
      valid |= bit;
      vdirty = dirty ? vdirty | bit : vdirty & ~bit;
      if (lane == way) {
        s_vic[warp][b] = tag;
        s_flush[warp][b] = way_src;
        tag = t;
        valid_word = 1;
        dirty_word = dirty;
        age = static_cast<int>(clock0 + (bw & 0x7fffffffu) + 1u);
        last_beat = static_cast<int>(bw & 0x7fffffffu);
      }
      if (w && (((match | bit) >> lane) & 1u))
        way_src = static_cast<long long>(bw & 0x7fffffffu);
      if (lane == b) {
        my_hit = hit;
        my_way = way;
        my_evict = !hit && way_dirty;
      }
    };
    if (count == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b) step(b);
    } else {
      for (int b = 0; b < count; ++b) step(b);
    }
    __syncwarp();
    const int my_vic = s_vic[warp][lane];
    const long long my_flush = my_evict ? s_flush[warp][lane] : -1;
    // The latest write to this beat's line among the group's beats up to
    // it, else the last write before the group.
    const unsigned same = __match_any_sync(kFull, mine ? my_line : -1 - lane);
    const unsigned writers = __ballot_sync(kFull, mine && my_w);
    const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
    const unsigned earlier = same & writers & upto;
    const int from = earlier ? 31 - __clz(earlier) : lane;
    const long long got = __shfl_sync(kFull, my_beat, from);
    if (mine) {
      hits[my_beat] = my_hit;
      ways_out[my_beat] = my_way;
      evict_out[my_beat] = my_evict;
      vic_tag_out[my_beat] = my_vic;
      src_out[my_beat] = earlier ? got : seen;
      flush_src_out[my_beat] = my_flush;
      const unsigned long long at = 2ull * static_cast<unsigned>(my_beat);
      if (my_evict) {
        long long v = static_cast<long long>(my_vic) * sets + set;
        v = v < 0 ? 0 : (v >= rows ? rows - 1 : v);
        atomicMax(row_key + v, (at + 1ull) << 32 |
                                   static_cast<unsigned>(my_flush));
      }
      if (!kWriteBack && my_w && in_rows)
        atomicMax(row_key + my_line,
                  (at + 2ull) << 32 | static_cast<unsigned>(my_beat));
    }
    __syncwarp();  // every lane has read the per-line entries
    if (in_rows && my_w && (same & writers & ~upto) == 0u)
      last_write[my_line] = static_cast<long long>(my_beat) + 1;
    __syncwarp();  // the slots and entries are free for the next group
  }
  if (live) {
    tags_out[slot] = tag;
    valid_out[slot] = valid_word;
    age_out[slot] = age;
    dirty_out[slot] = dirty_word;
    last_out[slot] = last_beat;
  }
}

// Each row's event key -- 0, or (2 * beat + kind + 1) << 32 | source --
// becomes the source, -1 for none, in place.
__global__ void row_keys_to_src_kernel(long long* __restrict__ row_src,
                                       long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= rows) return;
  const unsigned long long key = static_cast<unsigned long long>(row_src[r]);
  row_src[r] = key ? static_cast<long long>(key & 0xffffffffull) : -1;
}

// As cache_probe, plus is_write: (n,) uint8, 0 or 1; dirty: (sets, ways)
// int32; rows: the table's row count, every line id below it; write_back: 0
// or 1. Outputs also evict and vic_tag, (n,) int32, the new dirty bits, and
// the sources: src and flush_src (n,), last (sets, ways) and row_src
// (rows,), int64; last_write (rows,) int64 is scratch. row_src and
// last_write must hold zeros. 1 <= n < 2^31, n + sets * ways <= 2^32.
extern "C" int cache_probe_rw(const void* line_ids, const void* is_write,
                              const void* order, const void* set_start,
                              const void* tags, const void* valid,
                              const void* age, const void* dirty,
                              const void* clock, void* hits, void* ways_out,
                              void* evict, void* vic_tag, void* tags_out,
                              void* valid_out, void* age_out, void* dirty_out,
                              void* clock_out, void* src, void* flush_src,
                              void* last, void* row_src, void* last_write,
                              int sets, int ways, int n, int rows,
                              int write_back, void* stream) {
  if (sets < 1 || ways < 1 || ways > 32 || n < 1 || rows < 1 ||
      static_cast<long long>(n) + static_cast<long long>(sets) * ways >
          (1ll << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(sets) + kProbeWarps - 1) /
                            kProbeWarps);
  auto kernel = write_back ? cache_probe_rw_kernel<true>
                           : cache_probe_rw_kernel<false>;
  kernel<<<grid, kProbeWarps * 32, 0, s>>>(
      static_cast<const int*>(line_ids),
      static_cast<const unsigned char*>(is_write),
      static_cast<const long long*>(order),
      static_cast<const int*>(set_start), static_cast<const int*>(tags),
      static_cast<const int*>(valid), static_cast<const int*>(age),
      static_cast<const int*>(dirty), static_cast<const int*>(clock),
      static_cast<int*>(hits), static_cast<int*>(ways_out),
      static_cast<int*>(evict), static_cast<int*>(vic_tag),
      static_cast<int*>(tags_out), static_cast<int*>(valid_out),
      static_cast<int*>(age_out), static_cast<int*>(dirty_out),
      static_cast<int*>(clock_out), static_cast<long long*>(src),
      static_cast<long long*>(flush_src), static_cast<long long*>(last),
      static_cast<unsigned long long*>(row_src),
      static_cast<long long*>(last_write), sets, ways, n, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_keys_to_src_kernel<<<(rows + 255) / 256, 256, 0, s>>>(
      static_cast<long long*>(row_src), rows);
  return static_cast<int>(cudaGetLastError());
}

// Row resolve: out[r] = payload[s] for 0 <= s < n, extra[s - n] for s >= n,
// and fallback[fb_rows[r]] (fallback[r] without fb_rows) for s < 0, where
// s = src[r]. It writes the set-parallel engine's winner rows: the served
// lines (from the probe's src, falling back to the table row of the beat),
// the final Data RAM (from each way's last beat, falling back to the way's
// old content) and the new table (from row_src, falling back to the old
// row: one pass over the table that is the copy and the winner writes).
//
// Replaces no Pallas kernel: the reference's engine composes these copies
// from numpy gathers and last-writer scatters.
// Bound on the H100: bytes -- each output row written once and each row it
// copies read once. Design: one warp a row, neighbouring lanes on
// neighbouring 16-byte words (a 512-byte bf16 line is one word a lane); the
// warp reads its index first. Pure copies, so the output's bits are the
// chosen source's.
constexpr int kResolveWarps = 8;

template <typename V>
__global__ void __launch_bounds__(kResolveWarps * 32)
row_resolve_kernel(V* __restrict__ out, const long long* __restrict__ src,
                   const long long* __restrict__ fb_rows,
                   const V* __restrict__ payload, long long n,
                   const V* __restrict__ extra,
                   const V* __restrict__ fallback, long long rows,
                   long long words) {
  const long long r = static_cast<long long>(blockIdx.x) * kResolveWarps +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  const long long s = src[r];
  const V* from = s >= 0 ? (s < n ? payload + s * words
                                  : extra + (s - n) * words)
                         : fallback + (fb_rows ? fb_rows[r] : r) * words;
  V* to = out + r * words;
#pragma unroll 4
  for (long long k = threadIdx.x & 31; k < words; k += 32) to[k] = from[k];
}

template <typename V>
static void launch_resolve(void* out, const void* src, const void* fb_rows,
                           const void* payload, long long n,
                           const void* extra, const void* fallback,
                           long long rows, long long row_bytes,
                           cudaStream_t s) {
  const long long grid = (rows + kResolveWarps - 1) / kResolveWarps;
  row_resolve_kernel<V><<<static_cast<unsigned>(grid), kResolveWarps * 32, 0,
                          s>>>(
      static_cast<V*>(out), static_cast<const long long*>(src),
      static_cast<const long long*>(fb_rows), static_cast<const V*>(payload),
      n, static_cast<const V*>(extra), static_cast<const V*>(fallback), rows,
      row_bytes / static_cast<long long>(sizeof(V)));
}

// out: (rows, row_bytes) bytes; src: (rows,) int64, each -1 <= s <
// n + (extra's rows); fb_rows: (rows,) int64 or null; payload: (n,
// row_bytes); extra and fallback of the same row width. 16-byte words where
// the width and every base address allow, else bytes.
extern "C" int row_resolve(void* out, const void* src, const void* fb_rows,
                           const void* payload, long long n,
                           const void* extra, const void* fallback,
                           long long rows, long long row_bytes,
                           void* stream) {
  if (rows < 0 || n < 0 || row_bytes < 1 ||
      (rows + kResolveWarps - 1) / kResolveWarps > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = access_width(row_bytes, out, payload) == 16 &&
                    access_width(row_bytes, extra, fallback) == 16;
  if (wide)
    launch_resolve<uint4>(out, src, fb_rows, payload, n, extra, fallback,
                          rows, row_bytes, s);
  else
    launch_resolve<unsigned char>(out, src, fb_rows, payload, n, extra,
                                  fallback, rows, row_bytes, s);
  return static_cast<int>(cudaGetLastError());
}
