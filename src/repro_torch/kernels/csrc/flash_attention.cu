// Flash attention forward: GQA online-softmax attention in the model layout,
// o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / group] * hd^-0.5 | mask)
//              . v[b, j, h / group],
// with float32 scores, running max, running sum and output accumulators,
// and a causal, sliding-window or bidirectional mask.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:92
// (flash_attention_pallas), whose grid (BH, nq, nk) runs in order on one
// core and carries the accumulators over its `ki` axis in VMEM scratch,
// skips fully masked KV blocks with pl.when, and asserts that S divides by
// both block sizes. A CUDA grid has no order, so here the `ki` axis is a
// loop inside the block, from the first 64-key tile the window leaves live
// to the last tile causality leaves live (this replaces pl.when and the
// clamped kv_index); query rows and keys past S are zero-filled and never
// stored or attended, so any S >= 1 runs. The mask value is the finite
// -0.7 * FLT_MAX of both reference paths: -inf - (-inf) would make the
// correction factor NaN. Offsets are 64-bit.
//
// Bound on the H100: operations. At the serve path's prefill (8 x 1024
// tokens, 56 query heads over 8 KV heads, hd 128, bf16, causal) the two
// products are 120 GFLOP of live (query, key) pairs against 268 MB of q,
// k, v and o: 0.1217 ms at 989 TFLOP/s against 0.0801 ms at 3.35 TB/s.
//
// Two kernels, chosen by dtype:
//
// flash_fwd_tc_kernel (bf16 and f16 inputs): the tensor cores. One block
// of one warpgroup (128 threads) per (batch * head, 64 query rows), the
// heaviest causal tiles first. Q is loaded once into shared memory; 64-key
// K and V tiles go through rings of two, filled by 16-byte cp.async copies
// (tile t + 1 loads while tile t computes). Every tile sits in the
// no-swizzle core-matrix layout (8 rows x 16 bytes, 128 contiguous bytes),
// which takes every head dim that occurs (64, 80, 128; a 128-byte swizzle
// does not fit hd 80's 160-byte rows). S = Q K^T is hd / 16 wgmma
// m64n64k16 steps with both operands read from shared memory through
// descriptors; bf16 and f16 products are exact in float32, so S differs
// from the float32 kernel only in summation order. Scale, mask and the
// online softmax run on the float32 accumulator fragment (a thread holds
// parts of two rows; a row reduces over the 4 lanes of a quad; scores are
// scaled by hd^-0.5 * log2(e) so that each exponential is one exp2f), and
// l sums the float32 P. O += P V then takes P from registers: the
// accumulator fragment of S is the A fragment of the next product without
// shuffles, and V (keys as rows) is the B operand, read transposed.
//
// Why P is split. Rounding P once to bf16 before P V moves the output by
// about 2e-3 at the serve shape, 100 times the 3e-5 within which the
// reference's float32 P V holds. So P is split into terms of the input
// type, each the rounded remainder of the ones before, and O accumulates
// every term times V in float32. Two terms (P to about 2^-17) hold the
// kernel within 8.1e-6 of the plain float32 result, three (about 2^-26)
// within 3.3e-6, at no measurable cost (the kernel waits on latency, not
// on the tensor cores). The serve path's consistency check reads its
// random 60-layer model's amplification of last-bit differences, not
// this error: reordering the plain version's own float32 sums moves its
// logits 0.019 of the largest, against a 0.02 bound. Three terms and
// exp2f are the variant of four equivalent ones that passes that check;
// neither was chosen for the kernel's own precision.
//
// The output columns are wgmma n64 halves (hd <= 64 one, else two; columns
// past hd are computed from whatever the tile holds there and never
// stored). The epilogue divides by max(l, 1e-37) and rounds once to T, or
// stores the float32 result unrounded (out_f32). The head dim is a
// template parameter and every register operand is fenced before
// wgmma.fence: otherwise ptxas serializes every wgmma (notes C7515 and
// C7519). TMA, swizzled tiles, a producer warp and ping-pong warpgroups
// are later work.
//
// flash_fwd_kernel (float32 inputs): the CUDA cores, since TF32 would
// round q and k to 10 bits, far beyond the reference's 3e-5. Float32 FMAs
// bound it: at the encoder path's shape (8 x 1024 tokens, 16/16 heads of
// 80, bidirectional) the two products are 42.95 GFLOP, 0.641 ms at 67
// TFLOP/s, against 0.050 ms for its 167.8 MB of q, k, v and o at 3.35
// TB/s. So the design keeps the FMA pipes fed and shared memory off their
// way:
// - The head dim is a template parameter: every loop unrolls, and no lane
//   holds a column past hd.
// - A block of 256 threads takes 256 query rows of one (batch, head) up to
//   hd 80, 128 above (F32Block). Lane tx of a row group holds the scores
//   of its 8 rows against keys tx, tx + L, ... of each 64-key tile (L = 8
//   lanes a group up to hd 80, 16 above) and their output columns, in
//   registers: each K and V value read from shared memory feeds 8 FMAs,
//   each q value 8 or 4, each p value hd / L.
// - Q is loaded once, and the K and V tiles go through rings of two, all by
//   16-byte cp.async copies (rows past S zero-filled): tile t + 1 loads
//   while tile t computes, one block barrier per tile. The wrapper copies
//   a view whose rows do not start 16-byte aligned first.
// - Q, the rings and P fill 231,424 bytes at hd 80 and at hd 128: one
//   block of 8 warps an SM, with up to 255 registers a thread and no
//   spill. (Blocks of 16 warps cap a thread at 128 registers; with 8 rows
//   a thread they spilled and ran slower on the H100.)
// - P goes through shared memory to the lanes that hold the same rows, all
//   in one warp, so only __syncwarp orders it. A warp's row groups read
//   rows 8 apart, which share banks: Q's 16-byte chunks and P's keys are
//   swizzled by the row group.
// - Scores are scaled by hd^-0.5 * log2(e), so each exponential is one
//   exp2f; the mask value stays the finite kNeg. Each lane keeps its own
//   part of a row's running sum (the running max is the row's, so the
//   correction factors agree), and the L parts are summed once at the end.
// - A warp skips the products of a tile in which none of its rows has a
//   live key (causal and window), and masks element by element only where
//   a tile reaches past S, the diagonal or the window's edge for one of its
//   rows. The heaviest causal blocks (last query rows) run first.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>

constexpr int kTile = 64;         // keys per tile of the float32 kernel
constexpr float kNeg = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);     // round to nearest even, as torch's cast
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float lane(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

struct Strides {
  long long b, s, h;   // elements; the head_dim axis has stride 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The float32 kernel's block for head dim HD, 256 threads, one block (8
// warps) an SM. Up to kF32SmallHd: 256 query rows in row groups of 8
// lanes (8 keys of each tile a lane); above it, 128 rows in row groups of
// 16 lanes (4 keys a lane). A lane reads V two columns at a time where its
// columns pair up. Shared memory in floats: Q (rows x HD), a ring of two K
// tiles at a pitch of HD + 4 (a quarter-warp's 8 rows land on distinct
// banks), a ring of two V tiles and P (rows x 64): 231,424 bytes at hd 80
// and at hd 128.
constexpr int kF32SmallHd = 80;
template <int HD>
struct F32Block {
  static constexpr bool small = HD <= kF32SmallHd;
  static constexpr int rows = small ? 256 : 128;   // query rows a block
  static constexpr int lanes = small ? 8 : 16;     // lanes a row group
  static constexpr int threads = rows / 8 * lanes;
  static constexpr int kpl = kTile / lanes;        // keys a lane, each tile
  // Keys a pass of Q K^T: at 8 lanes two passes, or the 255 registers of
  // a thread spill.
  static constexpr int kpass = small ? kpl / 2 : kpl;
  static constexpr int groups = 32 / lanes;        // row groups a warp
  static constexpr int vec = HD % (2 * lanes) == 0 ? 2 : 1;  // V a load
  static constexpr int cols = HD / lanes;          // output columns a lane
  static constexpr int ldk = HD + 4;
  static constexpr int k_off = rows * HD;
  static constexpr int v_off = k_off + 2 * kTile * ldk;
  static constexpr int p_off = v_off + 2 * kTile * HD;
  static constexpr size_t smem = sizeof(float) * (p_off + rows * kTile);
  static_assert(smem <= 232448, "more than one block's shared memory");
  static_assert(threads == 256, "one block of 8 warps an SM");
};

// Rows r0 .. r0 + N - 1 of a (S, HD) float32 operand into shared memory at
// a pitch of LD floats, by 16-byte cp.async copies of THREADS threads;
// rows past S are zeros. Row r's 16-byte chunk c lands at chunk c ^ ((r /
// 8) % SW) (SW = 1: in order).
template <int HD, int N, int LD, int THREADS, int SW = 1>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int ch = HD / 4, n = N * ch;
#pragma unroll
  for (int it = 0; it < (n + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (n % THREADS == 0 || e < n) {
      const int r = e / ch, c = e - r * ch, row = r0 + r;
      const bool ok = row < S;
      cp_async16(smem_u32(dst + r * LD + 4 * (c ^ ((r >> 3) % SW))),
                 src + (ok ? row : 0) * row_stride + 4 * c, ok);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32Block<HD>::threads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int group, int causal, int window, float scale,
                 Strides qs, Strides ks, Strides vs) {
  using F = F32Block<HD>;
  constexpr int L = F::lanes, KPL = F::kpl, VEC = F::vec;
  constexpr int wrows = 8 * F::groups;     // query rows a warp
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;
  float* p_s = smem + F::p_off;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  // Heaviest causal blocks (last query rows) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::rows;
  const int tid = threadIdx.x, ty = tid / L, tx = tid % L;
  const int g = ty % F::groups;            // row group within the warp
  const int r0 = 8 * ty;                   // this thread's first row
  const int w0 = q0 + wrows * (tid / 32);  // this warp's first query row
  // The warp's row groups read rows 8 apart, which share banks: Q's
  // chunks and P's keys are swizzled by the row group.
  const int qsw = g, psw = g * L;
  const float scale_log2 = scale * kLog2e;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  // Live keys of this block: [k_first, k_last].
  int k_last = S - 1;
  if (causal) k_last = min(k_last, q0 + F::rows - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / kTile, t_last = k_last / kTile;
  auto k_at = [&](int t) {
    return smem + F::k_off + ((t - t_first) & 1) * kTile * F::ldk;
  };
  auto v_at = [&](int t) {
    return smem + F::v_off + ((t - t_first) & 1) * kTile * HD;
  };

  load_rows<HD, F::rows, HD, F::threads, F::groups>(q_s, qb, qs.s, q0, S);
  load_rows<HD, kTile, F::ldk, F::threads>(k_at(t_first), kb, ks.s,
                                           t_first * kTile, S);
  load_rows<HD, kTile, HD, F::threads>(v_at(t_first), vb, vs.s,
                                       t_first * kTile, S);
  cp_async_commit();

  float m[8], l[8], acc[8][F::cols];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < F::cols; ++jd) acc[i][jd] = 0.f;
  }

  for (int t = t_first; t <= t_last; ++t) {
    // Tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose ring slots tile t + 1 now takes.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (t < t_last) {
      load_rows<HD, kTile, F::ldk, F::threads>(k_at(t + 1), kb, ks.s,
                                               (t + 1) * kTile, S);
      load_rows<HD, kTile, HD, F::threads>(v_at(t + 1), vb, vs.s,
                                           (t + 1) * kTile, S);
      cp_async_commit();
    }
    const int k0 = t * kTile;
    // No row of this warp has a live key in the tile: its products would
    // add exact zeros (or be zeroed by the next correction factor).
    if (w0 >= S || (causal && k0 > w0 + wrows - 1) ||
        (window > 0 && k0 + kTile - 1 <= w0 - window))
      continue;
    const bool edge = k0 + kTile > S || (causal && k0 + kTile - 1 > w0) ||
                      (window > 0 && k0 <= w0 + wrows - 1 - window);
    const float* k_s = k_at(t);
    const float* v_s = v_at(t);

    // S = Q K^T: rows r0 .. r0 + 7 against keys tx + L c.
    float s[8][KPL];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[i][c] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < KPL; c0 += F::kpass) {
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 kv[F::kpass];
#pragma unroll
        for (int c = 0; c < F::kpass; ++c)
          kv[c] = *reinterpret_cast<const float4*>(
              &k_s[(tx + L * (c0 + c)) * F::ldk + d]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              &q_s[(r0 + i) * HD + 4 * ((d / 4) ^ qsw)]);
#pragma unroll
          for (int c = 0; c < F::kpass; ++c) {
            float& x = s[i][c0 + c];
            x = fmaf(qv.x, kv[c].x, x);
            x = fmaf(qv.y, kv[c].y, x);
            x = fmaf(qv.z, kv[c].z, x);
            x = fmaf(qv.w, kv[c].w, x);
          }
        }
      }
    }

    // Mask, online softmax in log2 units. The L lanes of a row group
    // differ only in tx, so xor shuffles over L / 2 .. 1 reduce a row.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + r0 + i;
      float tmax = kNeg;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        float& x = s[i][c];
        if (edge) {
          const int j = k0 + tx + L * c;
          const bool live = j < S && (!causal || j <= qi) &&
                            (window <= 0 || j > qi - window);
          x = live ? x * scale_log2 : kNeg;
        } else {
          x *= scale_log2;
        }
        tmax = fmaxf(tmax, x);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float corr = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float p = exp2f(s[i][c] - m_new);
        p_s[(r0 + i) * kTile + ((tx + L * c) ^ psw)] = p;
        psum += p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < F::cols; ++jd) acc[i][jd] *= corr;
    }
    __syncwarp();

    // O += P V, keys in order; a lane's columns VEC tx + VEC L n + e.
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &p_s[(r0 + i) * kTile + (c ^ psw)]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &v_s[(c + cc) * HD + VEC * tx];
#pragma unroll
        for (int n = 0; n < F::cols / VEC; ++n) {
          float vv[VEC];
          if constexpr (VEC == 2) {
            const float2 v2 =
                *reinterpret_cast<const float2*>(&vrow[VEC * L * n]);
            vv[0] = v2.x;
            vv[1] = v2.y;
          } else {
            vv[0] = vrow[L * n];
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[i][VEC * n + e] =
                  fmaf(lane(pv[i], cc), vv[e], acc[i][VEC * n + e]);
        }
      }
    }
    __syncwarp();   // P is read before the next tile writes it
  }

  // A row's sum: its L lanes' parts.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-37f);
    float* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * HD +
                  VEC * tx;
#pragma unroll
    for (int n = 0; n < F::cols / VEC; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[VEC * L * n + e] = acc[i][VEC * n + e] / den;
  }
}

template <int HD>
static int launch_f32_hd(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int KV, int causal,
                         int window, float scale, Strides qs, Strides ks,
                         Strides vs, cudaStream_t stream) {
  using F = F32Block<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * H, (S + F::rows - 1) / F::rows);
  flash_fwd_kernel<HD><<<grid, F::threads, F::smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / KV,
      causal, window, scale, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the float32 kernel one SM holds at head dim HD, with what
// decides it: out[0] blocks, [1] threads a block, [2] shared memory bytes
// a block, [3] registers a thread, [4] local (spilled) bytes a thread.
template <int HD>
static int occupancy_f32_hd(int* out) {
  using F = F32Block<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<HD>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], flash_fwd_kernel<HD>, F::threads, F::smem);
  out[1] = F::threads;
  out[2] = static_cast<int>(F::smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, f16)
// ---------------------------------------------------------------------------

constexpr int kTcTile = 64;       // query rows of a block, keys of a tile
constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kPTerms = 3;        // P = P_hi + P_mid + P_lo in the input type

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// leading-dimension byte offset (between core matrices along K) and the
// stride byte offset (between core matrices along M or N), each in 16-byte
// units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Operand fences: the compiler may move neither the definition of a
// wgmma's register operand below, nor a read of its result above, the
// fence. Without them it sinks the computation of the A fragments and the
// rescaling of O between the wgmmas, and ptxas then serializes every wgmma
// (each waits for its own result).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][j][k])::"memory");
}

// The 32 float32 accumulator registers of an m64n64k16 wgmma, as asm text
// and as in-out operands %0..%31.
#define FA_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// m64n64k16 with float32 accumulators: ss reads A and B from shared memory
// (both K-major); rs takes A from registers and B transposed (MN-major).
template <typename T>
struct Wgmma;

#define FA_WGMMA(T, TY)                                                      \
  template <>                                                                \
  struct Wgmma<T> {                                                          \
    __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,    \
                                              uint64_t b, int accumulate) {  \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
          FA_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                           \
          : FA_OUT32(d)                                                      \
          : "l"(a), "l"(b), "r"(accumulate));                                \
    }                                                                        \
    __device__ __forceinline__ static void rs(float (&d)[32],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t b) {                  \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
          FA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"             \
          : FA_OUT32(d)                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));    \
    }                                                                        \
  };
FA_WGMMA(__nv_bfloat16, "bf16")
FA_WGMMA(__half, "f16")
#undef FA_WGMMA
#undef FA_OUT32
#undef FA_D32

// Two floats in one 32-bit register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}
__device__ __forceinline__ uint32_t pack2(__half lo, __half hi) {
  return static_cast<uint32_t>(__half_as_ushort(lo)) |
         static_cast<uint32_t>(__half_as_ushort(hi)) << 16;
}

// One 64-row tile of a (rows, hd) operand into the core-matrix layout:
// element (r, d) at byte ((r / 8) * (hd / 8) + d / 8) * 128 + (r % 8) * 16
// + (d % 8) * 2. Chunk e of 16 bytes lands at byte 16 e, so the 8 lanes of
// a quarter-warp fill one core matrix (no bank conflict) and a warp reads
// 64 contiguous bytes from each of 8 rows. Rows r0 + r >= S are zeros.
template <int CM, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long row_stride, int r0,
                                          int S) {
#pragma unroll
  for (int it = 0; it < kTcTile * CM / kTcThreads; ++it) {
    const int e = threadIdx.x + it * kTcThreads;
    const int c = (e >> 3) % CM, r = r0 + ((e >> 3) / CM) * 8 + (e & 7);
    const bool ok = r < S;
    cp_async16(dst + 16 * e, src + (ok ? r : 0) * row_stride + 8 * c, ok);
  }
}

// Shared memory: Q, then a ring of two K tiles and a ring of two V tiles,
// 64 rows x hd each, plus the bytes that the second n64 half reads past the
// last V tile when hd < 128.
static inline size_t tc_smem_bytes(int hd) {
  return 5 * static_cast<size_t>(kTcTile) * hd * 2 + 1024;
}

// Scale, mask and online softmax of one tile of scores, in place: s[4 i +
// 2 rh + e] is row qi[rh], key k0 + 8 i + c2 + e, and becomes its
// probability. Scores, m and the exponents are in log2 units (scale_log2 =
// hd^-0.5 * log2(e)), so each exponential is one exp2f. Only a tile that
// reaches past S, the diagonal or the window's edge for some row of the
// block is masked element by element. l takes the tile's float32 sum; the
// output's correction factor is returned in corr, not applied.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int q0, int S,
                                             const int (&qi)[2], int c2,
                                             int causal, int window,
                                             float scale_log2) {
  const bool edge = k0 + kTcTile > S || (causal && k0 + kTcTile - 1 > q0) ||
                    (window > 0 && k0 <= q0 + kTcTile - 1 - window);
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float tmax = kNeg;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * rh + e];
        if (edge) {
          const int j = k0 + 8 * i + c2 + e;
          const bool live = j < S && (!causal || j <= qi[rh]) &&
                            (window <= 0 || j > qi[rh] - window);
          x = live ? x * scale_log2 : kNeg;
        } else {
          x *= scale_log2;
        }
        tmax = fmaxf(tmax, x);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[rh], tmax);
    corr[rh] = exp2f(m[rh] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * rh + e];
        x = exp2f(x - m_new);
        psum += x;
      }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l[rh] = l[rh] * corr[rh] + psum;
    m[rh] = m_new;
  }
}

// P as A fragments, split into kPTerms terms of T, each the remainder of
// the ones before rounded once (every remainder is exact in float32):
// register a of k-step kt holds row a % 2 (r or r + 8) at keys 16 kt +
// 8 (a / 2) + c2 + {0, 1}, which is s[4 (2 kt + a / 2) + 2 (a % 2) + {0,
// 1}]: the accumulator fragment of S is the A fragment, no shuffles.
template <typename T>
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&pf)[kPTerms][4][4]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * (2 * kt + a / 2) + 2 * (a % 2);
      float r0 = s[i], r1 = s[i + 1];
#pragma unroll
      for (int term = 0; term < kPTerms; ++term) {
        const T h0 = from_f32<T>(r0), h1 = from_f32<T>(r1);
        pf[term][kt][a] = pack2(h0, h1);
        r0 -= to_f32(h0);
        r1 -= to_f32(h1);
      }
    }
}

// Every cp.async group but the last committed has landed, and is visible
// to wgmma (which reads through the async proxy) in every thread.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The head dim is a template parameter so that every wgmma sequence is
// unrolled: a loop that carries an accumulator makes ptxas serialize the
// wgmmas (each then waits for its own result).
template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, void* __restrict__ o, int S,
                    int H, int group, int causal, int window, float scale,
                    Strides qs, Strides ks, Strides vs, int out_f32) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int cm = HD / 8;                   // 16-byte chunks of a row
  constexpr uint32_t tile = kTcTile * HD * 2;  // bytes of one tile
  constexpr uint32_t row_group = cm * 128;     // between 8-row groups
  constexpr int nh = HD > 64 ? 2 : 1;          // n64 halves of the output
  const uint32_t q_s = smem_u32(tc_smem);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  // Heaviest causal tiles (last query rows) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale_log2 = scale * 1.4426950408889634f;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  int k_last = S - 1;
  if (causal) k_last = min(k_last, q0 + kTcTile - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / kTcTile, t_last = k_last / kTcTile;
  // Tile t's K and V in their rings.
  auto k_at = [&](int t) { return q_s + tile * (1 + ((t - t_first) & 1)); };
  auto v_at = [&](int t) { return q_s + tile * (3 + ((t - t_first) & 1)); };

  // This thread's rows of the 64: r and r + 8; its columns of each n8
  // block of an accumulator: 2 * (lane % 4) and the next.
  const int r = warp * 16 + lane / 4;
  const int qi[2] = {q0 + r, q0 + r + 8};
  const int c2 = 2 * (lane % 4);
  float s[32], oacc[2][32];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = oacc[0][i] = oacc[1][i] = 0.f;
  uint32_t pf[kPTerms][4][4];

  // S = Q K(t)^T: hd / 16 k-steps, both operands K-major in shared memory.
  auto issue_s = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<T>::ss(s, smem_desc(q_s + 256 * kk, 128, row_group),
                   smem_desc(k_at(t) + 256 * kk, 128, row_group), kk > 0);
  };

  // Tile t + 1 loads while tile t computes.
  load_tile<cm>(q_s, qb, qs.s, q0, S);
  load_tile<cm>(k_at(t_first), kb, ks.s, t_first * kTcTile, S);
  load_tile<cm>(v_at(t_first), vb, vs.s, t_first * kTcTile, S);
  cp_async_commit();
  for (int t = t_first; t <= t_last; ++t) {
    if (t < t_last) {
      load_tile<cm>(k_at(t + 1), kb, ks.s, (t + 1) * kTcTile, S);
      load_tile<cm>(v_at(t + 1), vb, vs.s, (t + 1) * kTcTile, S);
    }
    cp_async_commit();
    cp_async_wait_prior();

    wg_fence();
    issue_s(t);
    wg_commit();
    wg_wait0();
    fence_acc(s);
    softmax_tile(s, m, l, corr, t * kTcTile, q0, S, qi, c2, causal, window,
                 scale_log2);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          oacc[0][4 * i + 2 * rh + e] *= corr[rh];
          oacc[1][4 * i + 2 * rh + e] *= corr[rh];
        }
    split_p<T>(s, pf);

    // O += P_hi V + P_mid V + P_lo V. V's core matrices: 128 bytes apart
    // along the output columns (N), one 8-key group (cm * 128) apart along
    // keys (K).
    fence_acc(oacc[0]);
    fence_acc(oacc[1]);
    fence_frag(pf);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (hh < nh) {
          const uint64_t dv = smem_desc(
              v_at(t) + 2 * row_group * kt + 1024 * hh, row_group, 128);
#pragma unroll
          for (int term = 0; term < kPTerms; ++term)
            Wgmma<T>::rs(oacc[hh], pf[term][kt], dv);
        }
    wg_commit();
    wg_wait0();
    fence_acc(oacc[0]);
    fence_acc(oacc[1]);
    __syncthreads();   // every warp is done with K(t) and V(t) before reuse
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (qi[rh] >= S) continue;
    const float den = fmaxf(l[rh], 1e-37f);
    const long long row = (static_cast<long long>(b) * S + qi[rh]) * H + h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * hh + 8 * i + c2;
        if (hh >= nh || col >= HD) continue;
        const float x0 = oacc[hh][4 * i + 2 * rh] / den;
        const float x1 = oacc[hh][4 * i + 2 * rh + 1] / den;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + row * HD +
                                     col) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<T*>(o) + row * HD + col) =
              pack2(from_f32<T>(x0), from_f32<T>(x1));
        }
      }
  }
}

template <typename T, int HD>
static int launch_tc_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int causal, int window,
                        float scale, Strides qs, Strides ks, Strides vs,
                        int out_f32, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * H, (S + kTcTile - 1) / kTcTile);
  flash_fwd_tc_kernel<T, HD><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, S, H, H / KV, causal, window, scale, qs,
      ks, vs, out_f32);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KV, int hd, int causal,
                     int window, float scale, Strides qs, Strides ks,
                     Strides vs, int out_f32, cudaStream_t stream) {
  switch (hd) {
#define FA_HD(HD)                                                            \
    case HD:                                                                 \
      return launch_tc_hd<T, HD>(q, k, v, o, B, S, H, KV, causal, window,    \
                                 scale, qs, ks, vs, out_f32, stream);
    FA_HD(16) FA_HD(32) FA_HD(48) FA_HD(64) FA_HD(80) FA_HD(96) FA_HD(112)
    FA_HD(128)
#undef FA_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q: (B, S, H, hd), k and v: (B, S, KV, hd), each with the given element
// strides for its batch, sequence and head axes and stride 1 along hd;
// o: (B, S, H, hd) contiguous. The caller checks: H % KV == 0, hd a
// multiple of 16 in [16, 128], window 0 (none) or >= 1, B * H < 2^31,
// S <= 65535 * 64.
//
// float32 q, k, v and o: the CUDA-core kernel. The caller also checks
// that every row of q, k and v starts 16-byte aligned.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, int causal, int window, float scale, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define FA_HD(HD)                                                            \
    case HD:                                                                 \
      return launch_f32_hd<HD>(q, k, v, o, B, S, H, KV, causal, window,      \
                               scale, qs, ks, vs, s);
    FA_HD(16) FA_HD(32) FA_HD(48) FA_HD(64) FA_HD(80) FA_HD(96) FA_HD(112)
    FA_HD(128)
#undef FA_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 kernel's residency at head dim hd (occupancy_f32_hd's five
// numbers into out).
extern "C" int flash_attention_fwd_occupancy(int hd, int* out) {
  switch (hd) {
#define FA_HD(HD)                                                            \
    case HD:                                                                 \
      return occupancy_f32_hd<HD>(out);
    FA_HD(16) FA_HD(32) FA_HD(48) FA_HD(64) FA_HD(80) FA_HD(96) FA_HD(112)
    FA_HD(128)
#undef FA_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 (dtype 1) or f16 (dtype 2) q, k, v: the tensor-core kernel; o in
// the input type, or float32 unrounded when out_f32. The caller also checks
// that every row of q, k and v starts 16-byte aligned.
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, int causal, int window, float scale, int dtype,
    int out_f32, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_tc<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                      window, scale, qs, ks, vs, out_f32, s);
    case 2:
      return launch_tc<__half>(q, k, v, o, B, S, H, KV, hd, causal, window,
                               scale, qs, ks, vs, out_f32, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

