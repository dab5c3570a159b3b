// Flash attention forward: GQA online-softmax attention in the model layout,
// o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / group] * hd^-0.5 | mask)
//              . v[b, j, h / group],
// with float32 scores, running max, running sum and output accumulators,
// and a causal, sliding-window or bidirectional mask.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas), whose grid (BH, nq, nk) runs in order on one
// core and carries the accumulators over its `ki` axis in VMEM scratch,
// skips fully masked KV blocks with pl.when, and asserts that S divides by
// both block sizes.
//
// Bound on the H100: operations. At the serve path's prefill (8 x 1024
// tokens, 56 query heads over 8 KV heads, hd 128, bf16, causal) the two
// products are 120 GFLOP against 268 MB of q, k, v and o. Design, simple
// first: one block of 256 threads per (batch * head, tile of 64 query
// rows); a CUDA grid has no order, so the `ki` axis becomes the loop over
// 64-key tiles inside the block, from the first tile the window leaves live
// to the last tile causality leaves live (this replaces pl.when and the
// clamped kv_index). Each K/V tile is staged in shared memory as float32;
// thread (ty, tx) of a 16 x 16 layout holds the scores of query rows
// 4ty..4ty+3 against keys tx, tx+16, tx+32, tx+48, and the output of those
// rows at columns tx + 16 * jd, in registers. Products are float32 FMAs on
// the CUDA cores: bf16 products are exact in float32, so the result is the
// plain version's up to float32 summation order (tensor-core WGMMA and TMA
// are later work). The mask value is the finite -0.7 * FLT_MAX of both
// reference paths: -inf - (-inf) would make the correction factor NaN. A
// ragged S is masked here (query rows and keys past S are zero-filled and
// never stored or attended), so any S >= 1 runs; offsets are 64-bit.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>

constexpr int kTile = 64;         // query rows and keys per tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kMaxHd = 128;
constexpr int kMaxSlices = kMaxHd / 16;   // output columns per thread
constexpr int kLdp = kTile + 4;           // row pitch of the probabilities
constexpr float kNeg = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
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

// Shared memory: q and k tiles at a pitch of hd + 4 floats (16-byte rows
// for float4 reads; a quarter-warp's 8 rows land on distinct banks), the v
// tile at hd, the probabilities at kLdp.
static inline size_t smem_bytes(int hd) {
  return sizeof(float) *
         (2 * kTile * (hd + 4) + kTile * hd + kTile * kLdp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int group, int hd, int causal, int window, float scale,
                 Strides qs, Strides ks, Strides vs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  float* q_s = smem;
  float* k_s = q_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* p_s = v_s + kTile * hd;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  // Heaviest causal tiles (last query rows) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nd = hd / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kTile * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd, i = q0 + r;
    q_s[r * ld + d] = i < S ? to_f32(qb[i * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kMaxSlices];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kMaxSlices; ++jd) acc[i][jd] = 0.f;
  }

  // Live keys of this query tile: [k_first, k_last].
  int k_last = S - 1;
  if (causal) k_last = min(k_last, q0 + kTile - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t = k_first / kTile; t <= k_last / kTile; ++t) {
    const int k0 = t * kTile;
    __syncthreads();   // the last tile's readers are done; q_s is loaded
    for (int e = tid; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd, j = k0 + r;
      k_s[r * ld + d] = j < S ? to_f32(kb[j * ks.s + d]) : 0.f;
      v_s[r * hd + d] = j < S ? to_f32(vb[j * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(4 * ty + i) * ld + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * c) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    // Mask, online softmax. The 16 threads of a row group are lanes of one
    // warp that differ only in tx, so xor shuffles over 1..8 reduce a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float tmax = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool live = j < S && (!causal || j <= qi) &&
                          (window <= 0 || j > qi - window);
        s[i][c] = live ? s[i][c] * scale : kNeg;
        tmax = fmaxf(tmax, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        p_s[(4 * ty + i) * kLdp + tx + 16 * c] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kMaxSlices; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kTile; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(4 * ty + i) * kLdp + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &v_s[(c + cc) * hd + tx];
#pragma unroll
        for (int jd = 0; jd < kMaxSlices; ++jd) {
          if (jd < nd) {
            const float vv = vrow[16 * jd];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][jd] = fmaf(lane(pv[i], cc), vv, acc[i][jd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-37f);
    T* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * hd;
#pragma unroll
    for (int jd = 0; jd < kMaxSlices; ++jd)
      if (jd < nd) orow[tx + 16 * jd] = from_f32<T>(acc[i][jd] / den);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KV, int hd, int causal, int window,
                  float scale, Strides qs, Strides ks, Strides vs,
                  cudaStream_t stream) {
  const size_t bytes = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * H, (S + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, hd, causal,
      window, scale, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// q: (B, S, H, hd), k and v: (B, S, KV, hd), each with the given element
// strides for its batch, sequence and head axes and stride 1 along hd;
// o: (B, S, H, hd) contiguous. dtype: 0 float32, 1 bfloat16, 2 float16.
// The caller checks: H % KV == 0, hd a multiple of 16 in [16, 128],
// window 0 (none) or >= 1, B * H < 2^31, S <= 65535 * 64.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, int causal, int window, float scale, int dtype,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, S, H, KV, hd, causal, window, scale,
                           qs, ks, vs, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                   window, scale, qs, ks, vs, s);
    case 2:
      return launch<__half>(q, k, v, o, B, S, H, KV, hd, causal, window,
                            scale, qs, ks, vs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
