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
// beat's write flag added. Per beat it also reports whether the miss
// evicts a valid dirty way (a victim write-back) and the tag of the way it
// replaces, both read before the update.
//
// Replaces no Pallas kernel: the reference runs this walk as an XLA
// lax.scan over per-set lanes (_tag_round in
// src/repro/core/trace_engine.py), whose step is copied here exactly:
//   evict      = !hit && valid[way] && dirty[way]
//   keep_dirty = hit && dirty[way] && !is_write
//   dirty[way] = write_back ? (is_write || keep_dirty) : keep_dirty
// Bound on the H100: like B5, the longest chain of dependent beats of one
// set. Design: B5's -- one warp per set, the ways on lanes, the beats
// grouped by set on the device and read 32 at a time -- with the write
// flag carried in bit 31 of the shuffled beat index (n < 2^31), one more
// ballot per beat for the valid dirty ways (on a hit the way is valid, so
// that ballot gives both the eviction and the kept dirty bit) and one
// more shuffle for the victim's tag.
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
                      int* __restrict__ clock_out, int sets, int ways, int n,
                      int write_back) {
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
  int dirty = live ? dirty_in[slot] : 0;
  int age = live ? age_in[slot] : INT_MAX;  // as in cache_probe_kernel
  const int lo = set_start[set], hi = set_start[set + 1];
  int beat = lo + lane < hi ? static_cast<int>(order[lo + lane]) : 0;
  int line = lo + lane < hi ? line_ids[beat] : 0;
  int write = lo + lane < hi ? is_write[beat] : 0;
  int next_beat =
      lo + 32 + lane < hi ? static_cast<int>(order[lo + 32 + lane]) : 0;
  for (int base = lo; base < hi; base += 32) {
    const int count = min(32, hi - base);
    const int my_beat = beat, my_tag = line / sets;
    const unsigned my_bw = static_cast<unsigned>(my_beat) |
                           (static_cast<unsigned>(write != 0) << 31);
    beat = next_beat;
    const bool more = base + 32 + lane < hi;
    line = more ? line_ids[beat] : 0;
    write = more ? is_write[beat] : 0;
    next_beat = base + 64 + lane < hi
                    ? static_cast<int>(order[base + 64 + lane]) : 0;
    int my_hit = 0, my_way = 0, my_evict = 0, my_vic = 0;
    for (int b = 0; b < count; ++b) {
      const unsigned bw = __shfl_sync(kFull, my_bw, b);
      const int t = __shfl_sync(kFull, my_tag, b);
      const bool w = (bw >> 31) != 0u;
      const unsigned match = __ballot_sync(kFull, live && valid && tag == t);
      const int oldest = __reduce_min_sync(kFull, age);
      const unsigned lru = __ballot_sync(kFull, age == oldest);
      const unsigned valid_dirty = __ballot_sync(kFull, live && valid && dirty);
      const bool hit = match != 0u;
      const int way = __ffs(hit ? match : lru) - 1;
      const int vic = __shfl_sync(kFull, tag, way);
      const bool way_dirty = ((valid_dirty >> way) & 1u) != 0u;
      if (lane == way) {
        const bool keep = hit && way_dirty && !w;
        dirty = (write_back && w) || keep;
        tag = t;
        valid = 1;
        age = static_cast<int>(clock0 + (bw & 0x7fffffffu) + 1u);
      }
      if (lane == b) {
        my_hit = hit;
        my_way = way;
        my_evict = !hit && way_dirty;
        my_vic = vic;
      }
    }
    if (lane < count) {
      hits[my_beat] = my_hit;
      ways_out[my_beat] = my_way;
      evict_out[my_beat] = my_evict;
      vic_tag_out[my_beat] = my_vic;
    }
  }
  if (live) {
    tags_out[slot] = tag;
    valid_out[slot] = valid;
    age_out[slot] = age;
    dirty_out[slot] = dirty;
  }
}

// As cache_probe, plus is_write: (n,) uint8, 0 or 1; dirty: (sets, ways)
// int32; write_back: 0 or 1. Outputs also evict and vic_tag, (n,) int32,
// and the new dirty bits. 1 <= n < 2^31.
extern "C" int cache_probe_rw(const void* line_ids, const void* is_write,
                              const void* order, const void* set_start,
                              const void* tags, const void* valid,
                              const void* age, const void* dirty,
                              const void* clock, void* hits, void* ways_out,
                              void* evict, void* vic_tag, void* tags_out,
                              void* valid_out, void* age_out, void* dirty_out,
                              void* clock_out, int sets, int ways, int n,
                              int write_back, void* stream) {
  if (sets < 1 || ways < 1 || ways > 32 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(sets) + kProbeWarps - 1) /
                            kProbeWarps);
  cache_probe_rw_kernel<<<grid, kProbeWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<int*>(clock_out), sets, ways, n, write_back != 0);
  return static_cast<int>(cudaGetLastError());
}
