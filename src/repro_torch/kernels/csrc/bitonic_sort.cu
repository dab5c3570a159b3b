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
// operations per byte. The composite order (key, id) is compared as the
// TPU kernel does, so the network is a total order and the result equals a
// stable sort; the pad keys INT32_MAX that ops.sort_with_indices appends
// sort after real INT32_MAX keys because their ids are larger.
//
// Design: stage (k, j) compares slots 2^j apart inside direction blocks of
// 2^k. A CUDA grid has no order, so a stage whose partners lie in
// different blocks needs a launch of its own (a global barrier), but every
// stage whose stride fits a chunk of C = 2^c elements can run inside one
// block, in shared memory (keys, ids and payload: 12 bytes an element, so
// C up to 16384 in the 227 KB a block may have). The launch plan, the same
// as kernel.py's stage_plan(n, chunk), which the wrapper passes in:
//   local (1, c)            stages k = 1..c, every j, in one launch;
//   for each k > c: global (k, j) for j = k-1..c, one launch each, then
//   local (k, k)            j = c-1..0 in one launch.
// A row of N <= C takes one launch. The first launch reads the inputs,
// writes the arrival ids itself and writes the outputs, so the wrapper
// neither clones nor builds the ids. Inside a local launch, a stage of
// stride >= 64 runs in shared memory with a barrier after it, and the
// stages of stride < 64, most of the network, run in registers: a warp
// holds a 64-element segment, two elements a lane, and exchanges them by
// shuffles. The chunk trades launches against parallelism: one block per
// chunk, so a large C leaves few blocks for a long row (1 x 32768 at C =
// 16384 is 3 launches on 2 blocks; at C = 2048, 15 launches on 16 blocks);
// the wrapper picks it.
#include "common.cuh"

// Stage (k_exp, j_exp) on the pair p of a row whose chunk starts at row
// position pos0: slots a and b = a + 2^j of block c of width 2^(j+1);
// sub-blocks of width 2^k alternate ascending and descending (by row
// position, not chunk position).
__device__ __forceinline__ void compare_exchange(int* keys, int* ids,
                                                 int* vals, int pos0, int p,
                                                 int j_exp, int k_exp) {
  const int a = ((p >> j_exp) << (j_exp + 1)) + (p & ((1 << j_exp) - 1));
  const int b = a + (1 << j_exp);
  const bool ascending = (((pos0 + a) >> k_exp) & 1) == 0;
  const int ka = keys[a], kb = keys[b];
  const int ia = ids[a], ib = ids[b];
  const bool gt = ka > kb || (ka == kb && ia > ib);
  if (gt == ascending) {
    keys[a] = kb;
    keys[b] = ka;
    ids[a] = ib;
    ids[b] = ia;
    const int va = vals[a];
    vals[a] = vals[b];
    vals[b] = va;
  }
}

// One global stage, in place: one thread per compare-exchange pair, all G
// rows in one grid.
__global__ void bitonic_stage_kernel(int* __restrict__ keys,
                                     int* __restrict__ ids,
                                     int* __restrict__ vals, int log_n,
                                     int j_exp, int k_exp, long long pairs) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long base = (t >> (log_n - 1)) << log_n;
  const int p = static_cast<int>(t & ((1LL << (log_n - 1)) - 1));
  compare_exchange(keys + base, ids + base, vals + base, 0, p, j_exp, k_exp);
}

// The pair of stage j whose slots this lane and lane ^ lane_mask hold, in
// registers: both lanes compute the same swap from the lower slot's
// (key, id) and the upper's, and each keeps its side.
__device__ __forceinline__ void exchange_lanes(int& key, int& id, int& val,
                                               unsigned mask, int lane_mask,
                                               bool lower, bool ascending) {
  const int pk = __shfl_xor_sync(mask, key, lane_mask);
  const int pi = __shfl_xor_sync(mask, id, lane_mask);
  const int pv = __shfl_xor_sync(mask, val, lane_mask);
  const int ka = lower ? key : pk, kb = lower ? pk : key;
  const int ia = lower ? id : pi, ib = lower ? pi : id;
  const bool gt = ka > kb || (ka == kb && ia > ib);
  if (gt == ascending) {
    key = pk;
    id = pi;
    val = pv;
  }
}

// Stages j = j_top..0 (j_top <= 5) of direction width 2^k_exp on a segment
// of up to 64 elements held two a lane, element x = 2 lane + s at row
// position pos + s: j >= 1 pairs lane with lane ^ 2^(j-1) (same s), j = 0
// pairs the lane's own two elements.
__device__ __forceinline__ void segment_stages(int (&key)[2], int (&id)[2],
                                               int (&val)[2], unsigned mask,
                                               int lane, int pos, int k_exp,
                                               int j_top) {
  const bool ascending = ((pos >> k_exp) & 1) == 0;
  for (int j = j_top; j >= 1; --j) {
    const bool lower = ((lane >> (j - 1)) & 1) == 0;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      exchange_lanes(key[s], id[s], val[s], mask, 1 << (j - 1), lower,
                     ascending);
  }
  if (j_top >= 0) {
    const bool gt = key[0] > key[1] || (key[0] == key[1] && id[0] > id[1]);
    if (gt == ascending) {
      int t = key[0]; key[0] = key[1]; key[1] = t;
      t = id[0]; id[0] = id[1]; id[1] = t;
      t = val[0]; val[0] = val[1]; val[1] = t;
    }
  }
}

// Stages k = k_first..k_last, j = min(k, c)-1..0 on one chunk of C = 2^c
// elements per block, C / 2 threads (at most 1024). The chunk lives in
// shared memory; a stage of stride >= 64 runs there, one pair a thread and
// a barrier after it, and the stages of stride < 64 (most of the network)
// run in registers: each warp takes 64-element segments, two elements a
// lane, and exchanges them by shuffles. With `first`, the chunk comes from
// keys_in / vals_in and its ids are its row positions; otherwise it is
// read from and written back to the outputs.
__global__ void bitonic_local_kernel(const int* __restrict__ keys_in,
                                     const int* __restrict__ vals_in,
                                     int* __restrict__ keys,
                                     int* __restrict__ ids,
                                     int* __restrict__ vals, int log_n,
                                     int log_c, int k_first, int k_last,
                                     int first) {
  extern __shared__ int chunk[];
  const int C = 1 << log_c;
  int* sk = chunk;
  int* si = chunk + C;
  int* sv = chunk + 2 * C;
  const long long base = static_cast<long long>(blockIdx.x) << log_c;
  const int pos0 = static_cast<int>(base & ((1LL << log_n) - 1));
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    if (first) {
      sk[e] = keys_in[base + e];
      si[e] = pos0 + e;
      sv[e] = vals_in[base + e];
    } else {
      sk[e] = keys[base + e];
      si[e] = ids[base + e];
      sv[e] = vals[base + e];
    }
  }
  __syncthreads();
  const int seg = C < 64 ? C : 64;
  const unsigned mask = seg == 64 ? 0xffffffffu : (1u << (seg / 2)) - 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = (blockDim.x + 31) / 32;
  for (int k_exp = k_first; k_exp <= k_last; ++k_exp) {
    const int j_top = min(k_exp, log_c) - 1;
    for (int j_exp = j_top; j_exp >= 6; --j_exp) {
      for (int p = threadIdx.x; p < C / 2; p += blockDim.x)
        compare_exchange(sk, si, sv, pos0, p, j_exp, k_exp);
      __syncthreads();
    }
    for (int sg = warp * seg; sg < C; sg += warps * seg) {
      const int2 k2 = reinterpret_cast<const int2*>(sk + sg)[lane];
      const int2 i2 = reinterpret_cast<const int2*>(si + sg)[lane];
      const int2 v2 = reinterpret_cast<const int2*>(sv + sg)[lane];
      int key[2] = {k2.x, k2.y}, id[2] = {i2.x, i2.y}, val[2] = {v2.x, v2.y};
      segment_stages(key, id, val, mask, lane, pos0 + sg + 2 * lane, k_exp,
                     min(j_top, 5));
      reinterpret_cast<int2*>(sk + sg)[lane] = make_int2(key[0], key[1]);
      reinterpret_cast<int2*>(si + sg)[lane] = make_int2(id[0], id[1]);
      reinterpret_cast<int2*>(sv + sg)[lane] = make_int2(val[0], val[1]);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    keys[base + e] = sk[e];
    ids[base + e] = si[e];
    vals[base + e] = sv[e];
  }
}

// keys_in, vals_in: (g, n) int32; keys, ids, vals: (g, n) int32 outputs;
// n a power of two >= 2, chunk 2^log_c with 2 <= chunk <= min(n, 16384).
// plan: plan_len entries of three ints, (0, k, j) a global stage, (1,
// k_first, k_last) a local launch; the first entry is local (1, c).
extern "C" int bitonic_sort_rows(const void* keys_in, const void* vals_in,
                                 void* keys, void* ids, void* vals, int g,
                                 int n, int log_c, const int* plan,
                                 int plan_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int C = 1 << log_c;
  const int local_threads = C / 2 < 1024 ? C / 2 : 1024;
  const size_t local_bytes = 12 * static_cast<size_t>(C);
  const unsigned chunks =
      static_cast<unsigned>(static_cast<long long>(g) * n / C);
  const long long pairs = static_cast<long long>(g) * (n / 2);
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((pairs + threads - 1) / threads);
  cudaError_t err = cudaSuccess;
  if (local_bytes > 48 * 1024) {   // beyond the default dynamic limit
    err = cudaFuncSetAttribute(bitonic_local_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(local_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int* k_out = static_cast<int*>(keys);
  int* i_out = static_cast<int*>(ids);
  int* v_out = static_cast<int*>(vals);
  for (int e = 0; e < plan_len; ++e) {
    const int kind = plan[3 * e], a = plan[3 * e + 1], b = plan[3 * e + 2];
    if (kind == 1) {
      bitonic_local_kernel<<<chunks, local_threads, local_bytes, s>>>(
          static_cast<const int*>(keys_in), static_cast<const int*>(vals_in),
          k_out, i_out, v_out, log_n, log_c, a, b, e == 0);
    } else {
      bitonic_stage_kernel<<<blocks, threads, 0, s>>>(k_out, i_out, v_out,
                                                      log_n, b, a, pairs);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
