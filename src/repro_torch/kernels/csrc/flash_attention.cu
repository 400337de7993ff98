// Flash-attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(hd)) v with
// an online softmax over K/V tiles, GQA, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py  flash_attention_pallas  (_kernel)
//
// What bounds it on this card. The arithmetic is fp32 throughout (the reference
// casts its tiles to fp32, so its p @ v is fp32 too), and fp32 products do not
// run on the tensor cores: the bound is 4 * hd operations per visible
// (query, key) pair at the card's fp32 rate (67 TFLOP/s), far above the bytes
// of q, k, v and o at the serving shapes (a 512-token prefill is 0.064 ms of
// operations against 0.013 ms of bytes). The scores never touch device memory.
//
// Design (a first, simple one: no wgmma, no TMA, no bf16 tensor-core path).
//   * One CTA of 256 threads per (batch, query head, tile of 64 query rows);
//     the grid is (query tiles, H, B). A loop inside the CTA walks the K/V
//     tiles of 64 keys, where the TPU kernel's grid walked its own steps.
//   * The CTA stages its Q tile once and each K and V tile in shared memory as
//     fp32 (bf16 inputs are widened on load), rows padded by 4 floats so that
//     the 16-byte reads of neighbouring threads fall in distinct banks. At
//     hd 128 that is 118,784 bytes of dynamic shared memory (69,632 at hd 64),
//     above the 48 KB default, hence cudaFuncSetAttribute before each launch.
//   * Thread (ty, tx) of the 16 x 16 layout owns query rows ty + 16 i and key
//     columns tx + 16 j (i, j < 4) of the 64 x 64 score tile: 64 fmaf per four
//     16-byte shared reads. The row max and row sum of the online softmax are
//     shuffles over the 16 lanes sharing ty; m, l and the output rows stay in
//     registers (4 rows x hd/16 columns of the output, as float4 at columns
//     4 tx + 64 jj). The probabilities go through shared memory to p @ v.
//   * Tiles wholly outside the causal and window band are skipped, so a
//     windowed prefill costs O(S * window), not O(S^2). A tile is visited
//     whenever any of its 64 rows may see a key in it.
//   * Rows that see no key at all (only possible with a window, past
//     Sk + window - 1) get what the reference gives them: every score is the
//     finite fill -1e30, so exp(0) = 1 for each key and the row averages all
//     values. The CTA holding such a row visits every tile. The fill is never
//     -inf, since -inf - (-inf) is NaN; a row whose first visited tile is all
//     masked carries p = 1 until alpha = exp(-1e30 - m) wipes it, as in the
//     reference. Keys past Sk (a ragged last tile) get p = 0.
//   * Offsets are 64-bit (B * H * S * hd exceeds 2^31 at long prompts).
//
// Numerics. Not bitwise: the sums run in another order than the reference's
// and the plain version's, so the kernel is held to a tolerance. The dot
// products and p @ v are written as explicit fmaf, since the build's
// -fmad=false would otherwise emit a multiply and an add; expf is the
// accurate one (no fast math); the output is acc / max(l, 1e-30), rounded to
// the output type (round to nearest even for bf16).
//
// Layout. The kernel takes q (B,H,Sq,hd) and k, v (B,KV,Sk,hd), contiguous, and
// writes o (B,H,Sq,hd) in q's type; the model's (b,s,H,hd) tensors are copied
// to that layout by the caller (models/layers.py::sdpa_or_flash).
//
// Plain C interface (loaded with ctypes): raw device pointers and a
// cudaStream_t; launches on that stream, does not synchronise, and returns the
// first CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRows = 4;            // query rows per thread: ty + 16 i
constexpr int kCols = 4;            // score columns per thread: tx + 16 j
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kPStride = kBK + kPad;
constexpr float kMaskFill = -1e30f; // the reference's fill: finite on purpose
static_assert(kBQ == kBK, "load_tile stages Q, K and V tiles of the same height");

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (HD + kPad) +
                          static_cast<size_t>(kBQ) * kPStride);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 (8 bytes) widened to fp32: a bf16 is the top half of its float
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const uint32_t c = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const uint32_t d = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) = make_uint2(a | (b << 16), c | (d << 16));
}

// rows [row0, row0 + 64) of a (nrows, HD) matrix into a padded fp32 tile;
// rows past nrows are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row0,
                                          long long nrows) {
  constexpr int kVecs = HD / 4;
  for (int f = threadIdx.x; f < kBK * kVecs; f += kThreads) {
    const int r = f / kVecs;
    const int c = (f % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) val = load4(src + (row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * (HD + kPad) + c) = val;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int group, long long sq, long long sk,
                 int causal, int has_window, long long window, float scale) {
  constexpr int kS = HD + kPad;     // shared row stride of Q, K and V
  constexpr int kOut = HD / 64;     // float4 output columns per thread
  static_assert(HD % 64 == 0, "16 threads x 4 columns cover the head dim in 64s");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kS;
  float* Vs = Ks + kBK * kS;
  float* Ps = Vs + kBK * kS;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long b = blockIdx.z;
  const int h = blockIdx.y;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBQ;
  const long long kv_head = b * (H / group) + h / group;
  const T* qb = q + (b * H + h) * sq * HD;
  const T* kb = k + kv_head * sk * HD;
  const T* vb = v + kv_head * sk * HD;
  T* ob = o + (b * H + h) * sq * HD;

  // the keys any row of this tile can see; all of them if a row sees none
  const long long q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  long long k_begin = 0, k_end = sk;
  const bool blind_row = has_window && (window < 1 || q_last >= sk + window - 1);
  if (!blind_row) {
    if (causal && q_last + 1 < k_end) k_end = q_last + 1;
    if (has_window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  }

  load_tile<T, HD>(Qs, qb, q0, sq);

  float m[kRows], l[kRows];
  float4 acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (long long k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(Ks, kb, k0, sk);
    load_tile<T, HD>(Vs, vb, k0, sk);
    __syncthreads();

    // scores: s[i][j] = q[ty + 16 i] . k[tx + 16 j]
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = load4(Qs + (ty + 16 * i) * kS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = load4(Ks + (tx + 16 * j) * kS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float t = fmaf(qv[i].x, kv[j].x, s[i][j]);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        }
    }

    // masks and the online softmax, row by row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qi = q0 + ty + 16 * i;
      float rmax = kMaskFill;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long ki = k0 + tx + 16 * j;
        const bool visible = ki < sk && (!causal || ki <= qi) &&
                             (!has_window || qi - ki < window);
        s[i][j] = visible ? s[i][j] * scale : kMaskFill;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = k0 + tx + 16 * j < sk ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        acc[i][jj].x *= alpha;
        acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha;
        acc[i][jj].w *= alpha;
      }
    }
    __syncthreads();

    // acc[i] += p[ty + 16 i, :] @ v[:, 4 tx + 64 jj : +4]
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = load4(Ps + (ty + 16 * i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[kOut];
#pragma unroll
        for (int jj = 0; jj < kOut; ++jj) vv[jj] = load4(Vs + (c + cc) * kS + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = comp(pv[i], cc);
#pragma unroll
          for (int jj = 0; jj < kOut; ++jj) fma4(acc[i][jj], p, vv[jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      const float4 a = acc[i][jj];
      store4(ob + qi * HD + 4 * tx + 64 * jj,
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
           long long KV, long long sq, long long sk, int causal, int has_window,
           long long window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<int>(H), static_cast<int>(H / KV), sq, sk, causal,
      has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B,H,sq,hd), k/v: (B,KV,sk,hd), o: (B,H,sq,hd); fp32 (bf16 = 0) or bf16
// (bf16 = 1); hd 64 or 128; window used when has_window; scale = 1/sqrt(hd)
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long B, long long H, long long KV, long long sq,
                        long long sk, long long hd, int bf16, int causal,
                        int has_window, long long window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || sq <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && !bf16)
    return launch<float, 64>(q, k, v, o, B, H, KV, sq, sk, causal, has_window, window, scale, s);
  if (hd == 128 && !bf16)
    return launch<float, 128>(q, k, v, o, B, H, KV, sq, sk, causal, has_window, window, scale, s);
  if (hd == 64 && bf16)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, sq, sk, causal, has_window, window,
                                     scale, s);
  if (hd == 128 && bf16)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, sq, sk, causal, has_window, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
