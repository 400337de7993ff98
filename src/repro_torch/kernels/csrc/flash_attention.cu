// Flash-attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(hd)) v with
// an online softmax over K/V tiles, GQA, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py  flash_attention_pallas  (_kernel)
//
// What bounds it on this card. The reference computes in fp32 (it casts its
// tiles to fp32, so its p @ v is fp32 too), and the tolerance (1e-4) rules out
// single-pass TF32, which keeps 10 bits of mantissa. On the CUDA cores the
// work is 4 * hd fp32 operations per visible (query, key) pair at 67 TFLOP/s
// (the first, simple design ran there at 26 TFLOP/s). On the tensor cores an
// fp32-accurate product takes the split x = hi + lo, hi = tf32(x) (cvt.rna),
// lo = x - hi rounded again, and three products:
//   a b ~ a_hi b_hi + (a_hi b_lo + a_lo b_hi)      (a_lo b_lo, 2^-22 of it, dropped)
// The big one runs as tf32 mma.sync m16n8k8. The two small ones need only
// ~8 bits, so they run together as one bf16 mma.sync m16n8k16 whose k axis
// holds [hi | lo] against [lo ; hi] (measured on an H100: a bf16 m16n8k16
// issues at the same rate as a tf32 m16n8k8, so this is 2 tensor-core
// instructions per 8-deep step where 3xTF32 takes 3; each product keeps ~19
// bits). So the bound is operations: 4 * hd per visible pair at the tf32 rate
// plus 8 * hd at the bf16 rate (495 and 989 TFLOP/s dense), twice the
// single-pass tf32 time. mma.sync reaches ~270 TFLOP/s of tf32 on this card
// (wgmma is needed for the 495). The bytes of q, k, v and o are below it at
// the serving shapes, and the scores never touch device memory.
//
// Design.
//   * One CTA of 8 warps per (query head, batch row, tile of 128 query rows);
//     warp w owns rows 16 w .. 16 w + 15 of the tile. The grid is (H, B, query
//     tiles) with the tile index reversed, so the tiles that see the most keys
//     (causal: the last ones) are dispatched first, for every head at once.
//   * Q is scaled by 1/sqrt(hd) and split once per CTA into a tf32 hi fragment
//     and the bf16 [hi | lo] fragment, kept in registers (fp32 at hd 128
//     keeps Q itself, 64 registers, and splits it at each use: both fragments
//     would take 128). Each K and V tile is split once when it lands in shared
//     memory: hi in place, and a correction plane holding, as bf16 pairs, lo
//     and hi of two consecutive k (K: two head columns; V: two keys) where the
//     bf16 B fragment reads them as one 8-byte word. A bf16 input is exact in
//     tf32: no lo and no correction plane, Q K^T one tf32 product, P V two
//     (P's hi and lo against V).
//   * The k index of the tf32 products is permuted (logical k = t, t + 4 read
//     physical 2t, 2t + 1) so that the S accumulators of one 8-key step are the
//     A fragment of P V as they stand: no shuffles and no staging of P. K is
//     read as 8-byte pairs at row stride hd + 8, V as 4-byte words at row
//     stride hd + 4, the correction planes as 8-byte words; all free of bank
//     conflicts.
//   * Copies: a ring of three K/V stages filled by cp.async (16-byte, .cg;
//     rows past Sk zero-filled). Iteration i starts the copy of tile i + 2,
//     splits tile i + 1 (each thread the chunks it copied itself, after its
//     cp.async.wait_group; V's rows in pairs) and multiplies tile i, the split
//     in the same basic block as the products so that the two overlap; one
//     barrier a tile publishes the split tile and frees the stage and plane
//     set just read. Tiles are 64 keys at hd 64 and 32 at hd 128.
//   * Shared memory per CTA: three stages and two plane sets (fp32:
//     correction planes; bf16: hi planes) of 64 or 32 keys x ((hd + 8) +
//     (hd + 4)) words; a bf16 stage holds raw bf16 rows of hd. fp32: 179,200
//     bytes at hd 64, 171,520 at hd 128; bf16: 120,832 and 117,760. Above the
//     48 KB default, hence cudaFuncSetAttribute before each launch.
//   * Each tile in two halves: both halves' scores first, then the softmax
//     and P V of each, so the scheduler overlaps one half's exps with the
//     other half's products (the tensor pipe otherwise idles while a warp
//     runs its softmax).
//   * Online softmax with the row max in registers (a quad of lanes shares a
//     row: two shuffles); the row sum is kept per lane and summed over the
//     quad once, at the end.
//   * Masks only where the band has an edge. Per warp and K tile: tiles wholly
//     outside the causal / window band are skipped, tiles wholly inside it skip
//     the per-element mask, and only the tiles that cross an edge pay it. The
//     CTA walks only the tiles some row of it may see.
//   * Rows that see no key at all (only possible with a window, past
//     Sk + window - 1) get what the reference gives them: every score is the
//     finite fill -1e30, so exp(0) = 1 for each key and the row averages all
//     values. A warp holding such a row visits every tile with the mask. The
//     fill is never -inf, since -inf - (-inf) is NaN; a row whose first
//     visited tile is all masked carries p = 1 until alpha = exp(-1e30 - m)
//     wipes it, as in the reference. Keys past Sk (a ragged last tile) get
//     p = 0.
//   * Offsets are 64-bit (B * H * S * hd exceeds 2^31 at long prompts).
//   * Not wgmma: its tf32 form needs B K-major, which V is not without a
//     transpose, and wgmma is kept for a bf16 model (ROADMAP).
//
// Numerics. Not bitwise: the sums run in another order than the reference's
// and the plain version's, and each product keeps ~19 bits, so the kernel is
// held to a tolerance (kernels/cases.py ATTENTION_TOL; ~1e-6 measured). expf
// is the accurate one (no fast math); the output is acc / max(l, 1e-30),
// rounded to the output type (round to nearest even for bf16).
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

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;    // query rows per CTA, 16 per warp
constexpr int kStages = 3;          // K/V tiles in the cp.async ring
constexpr float kMaskFill = -1e30f; // the reference's fill: finite on purpose

enum Mode { kSkip, kFull, kEdge };

template <typename T, int HD>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = HD == 64 ? 64 : 32;   // keys per K/V tile
  static constexpr int KS = HD + 8;                // fp32 row stride of a K plane
  static constexpr int VS = HD + 4;                // fp32 row stride of a V plane
  static constexpr int RS = kF32 ? 0 : HD;         // bf16 row stride of a raw stage
  static constexpr int kPlanes = kBK * (KS + VS);  // floats of one K + V plane pair
  // fp32: three stages (split to hi in place), then two sets of correction planes;
  // bf16: three stages of raw bf16 rows, then two sets of hi planes
  static constexpr size_t kStageBytes = kF32 ? 4 * size_t(kPlanes) : 2 * size_t(kBK) * 2 * HD;
  static constexpr size_t kSetBytes = 4 * size_t(kPlanes);
  static constexpr size_t kBytes = kStages * kStageBytes + 2 * kSetBytes;
  static_assert(kBytes <= 232448, "shared memory over a block's 227 KB");
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, m16n8k8, tf32 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores, m16n8k16, bf16 inputs, fp32 accumulators: the
// two small products of the fp32 split at once (a = [hi | lo] along k)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even) in one word, first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(second), "f"(first));
  return r;
}

// 16 bytes from device memory to shared memory, asynchronously; zero-filled
// when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// two consecutive elements of a row, widened to fp32 (bf16 is the top half of its float)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(raw << 16), __uint_as_float(raw & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  *reinterpret_cast<uint32_t*>(p) = lo | (hi << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start the copy of keys [k0, k0 + kBK) of K and V into one stage: fp32 into
// the padded planes themselves, bf16 into raw rows of hd.
template <typename T, int HD>
__device__ __forceinline__ void issue_tile(T* kdst, T* vdst, const T* kb, const T* vb,
                                           long long k0, long long sk) {
  using L = Layout<T, HD>;
  constexpr int kBK = L::kBK;
  constexpr int kE = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kCPR = HD / kE;         // chunks per row
  constexpr int kKS = L::kF32 ? L::KS : L::RS;
  constexpr int kVS = L::kF32 ? L::VS : L::RS;
  static_assert(kBK * kCPR % (2 * kThreads) == 0, "whole chunk pairs per thread");
  // chunk f is row f / kCPR; fp32 copies V's rows in pairs (2 rp, 2 rp + 1)
  // at one column chunk instead, since its split pairs keys
#pragma unroll
  for (int i = 0; i < kBK * kCPR / kThreads; ++i) {
    const int f = threadIdx.x + i * kThreads;
    const int r = f / kCPR;
    const int c = (f % kCPR) * kE;
    const bool ok = k0 + r < sk;
    cp_async16(kdst + r * kKS + c, kb + (ok ? k0 + r : 0) * HD + c, ok);
    int rv = r, cv = c;
    if constexpr (L::kF32) {
      const int fv = threadIdx.x + (i >> 1) * kThreads;
      rv = 2 * (fv / kCPR) + (i & 1);
      cv = (fv % kCPR) * kE;
    }
    const bool okv = k0 + rv < sk;
    cp_async16(vdst + rv * kVS + cv, vb + (okv ? k0 + rv : 0) * HD + cv, okv);
  }
}

// x split as hi = tf32(x), lo = x - hi (exact), and the word pair a bf16
// m16n8k16 B fragment takes for two consecutive k: (lo, lo') and (hi, hi')
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hx, uint32_t& hy,
                                           uint32_t& w_lo, uint32_t& w_hi) {
  hx = tf32(x);
  hy = tf32(y);
  const float hxf = __uint_as_float(hx), hyf = __uint_as_float(hy);
  w_lo = pack_bf16(x - hxf, y - hyf);
  w_hi = pack_bf16(hxf, hyf);
}

// Split the chunks this thread copied (after its cp.async.wait_group). fp32
// rounds each value to tf32 hi in place and writes the correction planes: for
// K, per row and pair of head columns (2p, 2p + 1), the words (lo, lo') and
// (hi, hi') in bf16 at word 2p; for V, per pair of keys (2rp, 2rp + 1) and
// column c, the same two words at 8-byte slot rp * VS + c. bf16 widens its raw
// rows into the fp32 hi planes (exact in tf32; no correction: lo is zero).
template <typename T, int HD>
__device__ __forceinline__ void split_tile(T* kst, T* vst, float* kp, float* vp) {
  using L = Layout<T, HD>;
  constexpr int kBK = L::kBK;
  constexpr int kE = 16 / sizeof(T);
  constexpr int kCPR = HD / kE;
  if constexpr (L::kF32) {
#pragma unroll
    for (int i = 0; i < kBK * kCPR / kThreads; ++i) {
      const int f = threadIdx.x + i * kThreads;
      const int r = f / kCPR;
      const int c = (f % kCPR) * kE;
      float* src = reinterpret_cast<float*>(kst) + r * L::KS + c;
      const float4 x = *reinterpret_cast<const float4*>(src);
      uint4 h, w;
      split_pair(x.x, x.y, h.x, h.y, w.x, w.y);
      split_pair(x.z, x.w, h.z, h.w, w.z, w.w);
      *reinterpret_cast<uint4*>(src) = h;
      *reinterpret_cast<uint4*>(kp + r * L::KS + c) = w;
    }
#pragma unroll
    for (int i = 0; i < kBK * kCPR / kThreads / 2; ++i) {
      const int fv = threadIdx.x + i * kThreads;
      const int rp = fv / kCPR;
      const int c = (fv % kCPR) * kE;
      float* s0 = reinterpret_cast<float*>(vst) + 2 * rp * L::VS + c;
      float* s1 = s0 + L::VS;
      const float4 x0 = *reinterpret_cast<const float4*>(s0);
      const float4 x1 = *reinterpret_cast<const float4*>(s1);
      uint4 h0, h1, wa, wb;
      split_pair(x0.x, x1.x, h0.x, h1.x, wa.x, wa.y);
      split_pair(x0.y, x1.y, h0.y, h1.y, wa.z, wa.w);
      split_pair(x0.z, x1.z, h0.z, h1.z, wb.x, wb.y);
      split_pair(x0.w, x1.w, h0.w, h1.w, wb.z, wb.w);
      *reinterpret_cast<uint4*>(s0) = h0;
      *reinterpret_cast<uint4*>(s1) = h1;
      float* dst = vp + 2 * (rp * L::VS + c);
      *reinterpret_cast<uint4*>(dst) = wa;
      *reinterpret_cast<uint4*>(dst + 4) = wb;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBK * kCPR / kThreads; ++i) {
      const int f = threadIdx.x + i * kThreads;
      const int r = f / kCPR;
      const int c = (f % kCPR) * kE;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const uint4 raw = *reinterpret_cast<const uint4*>((side ? vst : kst) + r * L::RS + c);
        float* dst = side ? vp + r * L::VS + c : kp + r * L::KS + c;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(raw.x << 16, raw.x & 0xffff0000u, raw.y << 16, raw.y & 0xffff0000u);
        *reinterpret_cast<uint4*>(dst + 4) =
            make_uint4(raw.z << 16, raw.z & 0xffff0000u, raw.w << 16, raw.w & 0xffff0000u);
      }
    }
  }
}

// split_tile on a stage and a plane set as the ring lays them out
template <typename T, int HD>
__device__ __forceinline__ void split_next(T* st, float* planes) {
  using L = Layout<T, HD>;
  split_tile<T, HD>(st, st + (L::kF32 ? L::kBK * L::KS : L::kBK * HD), planes,
                    planes + L::kBK * L::KS);
}

// What a warp's tile step reads besides its fragments: the tile's planes and
// the masks' arguments.
struct TileCtx {
  const float* Kh;   // K hi plane (fp32: the stage itself)
  const float* Kl;   // K correction plane (fp32 only)
  const float* Vh;
  const float* Vl;   // V correction plane (fp32 only)
  long long k0, ra, sk, window;
  int causal, has_window, g, t;
  float scale;   // applied to the scores of bf16 inputs
};

// The A fragments of Q for one k-step from its four values x = (Q[g][2t],
// Q[g+8][2t], Q[g][2t+1], Q[g+8][2t+1]) (the tf32 fragment's permuted k):
// the tf32 hi fragment, and the bf16 m16n8k16 fragment [hi | lo] in natural k
// order (a0 = row g, k 2t and 2t + 1 of hi; a2 the same of lo).
__device__ __forceinline__ void q_frags(const float (&x)[4], uint32_t (&hi)[4],
                                        uint32_t (&corr)[4]) {
  float lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32(x[e]);
    lo[e] = x[e] - __uint_as_float(hi[e]);
  }
  corr[0] = pack_bf16(__uint_as_float(hi[0]), __uint_as_float(hi[2]));
  corr[1] = pack_bf16(__uint_as_float(hi[1]), __uint_as_float(hi[3]));
  corr[2] = pack_bf16(lo[0], lo[2]);
  corr[3] = pack_bf16(lo[1], lo[3]);
}

// One half of a K tile (NP n-tiles of 8 keys): S = Q K^T into sh; n-tile j
// holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of its 8 keys. fp32: per
// k-step, hi hi on tf32 and hi lo + lo hi in one bf16 m16n8k16 (the
// correction words sit at the same word offset as the hi pair); bf16 inputs
// are exact in tf32: one product.
template <bool F32, bool QLO, int HD, int NP, int QLR>
__device__ __forceinline__ void tile_scores(float (&sh)[NP][4], int half,
                                            const uint32_t (&qh)[HD / 8][4],
                                            const uint32_t (&qc)[QLR][4], const TileCtx& c) {
  constexpr int KS = HD + 8;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sh[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t ah[4], ac[4];
    if constexpr (QLO) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = qh[ks][e];
        ac[e] = qc[ks][e];
      }
    } else if constexpr (F32) {
      // split here, in the tile loop: hoisted out of it, the fragments would
      // take 128 registers and spill (the volatile asm keeps it here)
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t raw = qh[ks][e];
        asm volatile("" : "+r"(raw));
        x[e] = __uint_as_float(raw);
      }
      q_frags(x, ah, ac);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[e] = qh[ks][e];
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int off = (8 * (j + half * NP) + c.g) * KS + 8 * ks + 2 * c.t;
      const uint2 bh = *reinterpret_cast<const uint2*>(c.Kh + off);
      if constexpr (F32) {
        const uint2 bc = *reinterpret_cast<const uint2*>(c.Kl + off);
        mma_bf16(sh[j], ac, bc.x, bc.y);
      }
      mma(sh[j], ah, bh.x, bh.y);
    }
  }
}

// The masks (edge tiles only), the online softmax of rows g and g + 8 over
// the half, and O += P V. The S accumulators of an 8-key step are the tf32 A
// fragment (a0, a1, a2, a3) = (s0, s2, s1, s3) under the permuted k, and
// (in natural key order) the bf16 fragment [hi | lo] of the correction.
template <bool F32, bool MASKED, int HD, int NP>
__device__ __forceinline__ void tile_softmax_pv(float (&sh)[NP][4], int half, float (&m)[2],
                                                float (&l)[2], float (&acc)[HD / 8][4],
                                                const TileCtx& c) {
  constexpr int VS = HD + 4;
  float rmax[2] = {kMaskFill, kMaskFill};
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = F32 ? sh[j][e] : sh[j][e] * c.scale;
      if constexpr (MASKED) {
        const long long qi = c.ra + c.g + 8 * (e >> 1);
        const long long ki = c.k0 + 8 * (j + half * NP) + 2 * c.t + (e & 1);
        const bool visible = ki < c.sk && (!c.causal || ki <= qi) &&
                             (!c.has_window || qi - ki < c.window);
        x = visible ? x : kMaskFill;
      }
      sh[j][e] = x;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m_new = fmaxf(m[rr], quad_max(rmax[rr]));
    alpha[rr] = expf(m[rr] - m_new);
    m[rr] = m_new;
    l[rr] *= alpha[rr];
  }
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(sh[j][e] - m[e >> 1]);
      if constexpr (MASKED) {
        if (c.k0 + 8 * (j + half * NP) + 2 * c.t + (e & 1) >= c.sk) p = 0.f;
      }
      sh[j][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int row = 8 * (j + half * NP) + 2 * c.t;
    const float* v0 = c.Vh + row * VS + c.g;
    uint32_t ph[4], pc[4];
    if constexpr (F32) {
      q_frags({sh[j][0], sh[j][2], sh[j][1], sh[j][3]}, ph, pc);
      const float* w0 = c.Vl + row * VS + 2 * c.g;   // slot (row / 2) * VS + g
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const uint2 bc = *reinterpret_cast<const uint2*>(w0 + 16 * n);
        mma_bf16(acc[n], pc, bc.x, bc.y);
        mma(acc[n], ph, __float_as_uint(v0[8 * n]), __float_as_uint(v0[VS + 8 * n]));
      }
    } else {
      // V is exact in tf32: P's two parts against it
      uint32_t pl[4];
      split(sh[j][0], ph[0], pl[0]);
      split(sh[j][2], ph[1], pl[1]);
      split(sh[j][1], ph[2], pl[2]);
      split(sh[j][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const uint32_t b0 = __float_as_uint(v0[8 * n]);
        const uint32_t b1 = __float_as_uint(v0[VS + 8 * n]);
        mma(acc[n], pl, b0, b1);
        mma(acc[n], ph, b0, b1);
      }
    }
  }
}

// Both halves' scores first, then the softmax and P V of each: the second
// half's products overlap the first half's exps, and the second half's exps
// the first half's P V (the tensor pipe otherwise idles during a softmax).
// It first splits the next tile's chunks of this thread (in the same basic
// block, so that the split overlaps the products too).
template <typename T, bool QLO, bool MASKED, int HD, int NP, int QLR>
__device__ __forceinline__ void tile_step(const uint32_t (&qh)[HD / 8][4],
                                          const uint32_t (&qc)[QLR][4], float (&m)[2],
                                          float (&l)[2], float (&acc)[HD / 8][4],
                                          const TileCtx& c, T* next, float* next_planes) {
  constexpr bool F32 = Layout<T, HD>::kF32;
  split_next<T, HD>(next, next_planes);
  float s0[NP][4], s1[NP][4];
  tile_scores<F32, QLO, HD, NP, QLR>(s0, 0, qh, qc, c);
  tile_scores<F32, QLO, HD, NP, QLR>(s1, 1, qh, qc, c);
  tile_softmax_pv<F32, MASKED, HD, NP>(s0, 0, m, l, acc, c);
  tile_softmax_pv<F32, MASKED, HD, NP>(s1, 1, m, l, acc, c);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int group, long long sq, long long sk,
                 int causal, int has_window, long long window, float scale) {
  using L = Layout<T, HD>;
  constexpr bool kF32 = L::kF32;
  constexpr int kBK = L::kBK;
  constexpr int kNP = kBK / 16;             // score n-tiles (8 keys) in each half of a tile
  constexpr int KS = L::KS, VS = L::VS;
  constexpr int kDK = HD / 8;               // k-steps of Q K^T, n-tiles of O
  constexpr bool kQLo = kF32 && HD == 64;   // Q's correction fragment kept in registers
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // stage i of the ring; V follows K in a stage. Set i of the planes: fp32 lo
  // planes, bf16 hi planes; K's then V's
  auto stage = [&](int i) { return reinterpret_cast<T*>(smem + i * L::kStageBytes); };
  constexpr int kVOff = kF32 ? kBK * KS : kBK * HD;   // V's offset in a stage, in elements
  auto plane = [&](int i) {
    return reinterpret_cast<float*>(smem + kStages * L::kStageBytes + i * L::kSetBytes);
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;                  // the row of a fragment (and row + 8)
  const int t = lane & 3;                   // the pair of columns 2t, 2t + 1
  const long long h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long q0 = static_cast<long long>(gridDim.z - 1 - blockIdx.z) * kBQ;
  const long long kv_head = b * (H / group) + h / group;
  const T* qb = q + (b * H + h) * sq * HD;
  const T* kb = k + kv_head * sk * HD;
  const T* vb = v + kv_head * sk * HD;
  T* ob = o + (b * H + h) * sq * HD;

  // the keys row qi may see: [lo(qi), hi(qi)], empty for a blind row
  auto key_lo = [&](long long qi) {
    return has_window && qi - window + 1 > 0 ? qi - window + 1 : 0LL;
  };
  auto key_hi = [&](long long qi) { return causal && qi < sk - 1 ? qi : sk - 1; };

  // the keys any row of this CTA can see; all of them if a row sees none
  const long long q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  long long k_begin = 0, k_end = sk;
  if (!(has_window && (window < 1 || q_last >= sk + window - 1))) {
    k_begin = key_lo(q0);
    k_end = key_hi(q_last) + 1;
  }
  // this warp's rows [ra, rz]
  const long long ra = q0 + 16 * warp;
  const long long rz = (ra + 15 < sq ? ra + 15 : sq - 1);
  const bool warp_blind = has_window && (window < 1 || rz >= sk + window - 1);

  // Tile i of this CTA's walk sits in stage i % 3 and plane set i % 2. The
  // first two tiles' copies start before Q is loaded, so the two latencies
  // overlap.
  const long long tile0 = k_begin / kBK;
  const int ntiles = static_cast<int>((k_end + kBK - 1) / kBK - tile0);
  if (ntiles > 0) issue_tile<T, HD>(stage(0), stage(0) + kVOff, kb, vb, tile0 * kBK, sk);
  cp_async_commit();
  if (ntiles > 1) issue_tile<T, HD>(stage(1), stage(1) + kVOff, kb, vb, (tile0 + 1) * kBK, sk);
  cp_async_commit();

  // Q fragments of this lane: rows ra + g and ra + g + 8, columns 8 ks + 2t, + 1
  // (the permuted k: a0 / a2 hold 2t / 2t + 1 of row g, a1 / a3 of row g + 8)
  uint32_t qh[kDK][4];
  uint32_t qc[kQLo ? kDK : 1][4];
  {
    const long long r0 = ra + g, r1 = ra + g + 8;
#pragma unroll
    for (int ks = 0; ks < kDK; ++ks) {
      const int d = 8 * ks + 2 * t;
      const float2 x0 = r0 < sq ? load2(qb + r0 * HD + d) : make_float2(0.f, 0.f);
      const float2 x1 = r1 < sq ? load2(qb + r1 * HD + d) : make_float2(0.f, 0.f);
      // fp32 is scaled once here (exact at hd 64, where the scale is 1/8); bf16
      // is scaled on the scores, since q * scale need not be exact in tf32
      const float qs = kF32 ? scale : 1.f;
      const float x[4] = {x0.x * qs, x1.x * qs, x0.y * qs, x1.y * qs};
      if constexpr (kQLo) {
        q_frags(x, qh[ks], qc[ks]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qh[ks][i] = __float_as_uint(x[i]);   // fp32 at hd 128: split at use; bf16: exact
      }
    }
  }

  float m[2] = {kMaskFill, kMaskFill};  // rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[kDK][4];
#pragma unroll
  for (int n = 0; n < kDK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  // Each iteration starts the copy of tile i + 2, splits tile i + 1 (its own
  // chunks, after its cp.async.wait_group) and multiplies tile i; its one
  // barrier publishes tile i + 1 and frees stage i and set i for i + 3 and i + 2.
  cp_async_wait1();
  if (ntiles > 0) split_next<T, HD>(stage(0), plane(0));
  __syncthreads();

  for (int i = 0; i < ntiles; ++i) {
    if (i + 2 < ntiles) {
      T* next = stage((i + 2) % kStages);
      issue_tile<T, HD>(next, next + kVOff, kb, vb, (tile0 + i + 2) * kBK, sk);
    }
    cp_async_commit();
    cp_async_wait1();
    // tile i + 1's stage and plane set; past the last tile, a stage that is
    // not in use is split again to no effect (tf32 rounding is idempotent;
    // the plane set it writes is free), which keeps the split unconditional
    T* next = stage((i + 1) % kStages);
    float* next_planes = plane((i + 1) & 1);

    const long long k0 = (tile0 + i) * kBK;
    T* kst = stage(i % kStages);
    const float* Kp = plane(i & 1);
    const float* Vp = Kp + kBK * KS;
    const TileCtx ctx = {kF32 ? reinterpret_cast<const float*>(kst) : Kp, Kp,
                         kF32 ? reinterpret_cast<const float*>(kst + kVOff) : Vp, Vp,
                         k0, ra, sk, window, causal, has_window, g, t, scale};
    const long long kz = k0 + kBK - 1;
    Mode mode = kEdge;
    if (ra >= sq) {
      mode = kSkip;
    } else if (!warp_blind) {
      if (k0 > key_hi(rz) || kz < key_lo(ra))
        mode = kSkip;
      else if (kz < sk && key_lo(rz) <= k0 && kz <= key_hi(ra))
        mode = kFull;
    }
    if (mode == kFull)
      tile_step<T, kQLo, false, HD, kNP>(qh, qc, m, l, acc, ctx, next, next_planes);
    else if (mode == kEdge)
      tile_step<T, kQLo, true, HD, kNP>(qh, qc, m, l, acc, ctx, next, next_planes);
    else
      split_next<T, HD>(next, next_planes);
    __syncthreads();   // tile i + 1 is split; stage i and set i are free
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long qi = ra + g + 8 * rr;
    const float denom = fmaxf(quad_sum(l[rr]), 1e-30f);
    if (qi >= sq) continue;
#pragma unroll
    for (int n = 0; n < kDK; ++n)
      store2(ob + qi * HD + 8 * n + 2 * t, acc[n][2 * rr] / denom, acc[n][2 * rr + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// The wide head dims (96 and 256): flash_wide_kernel.
//
// The design above does not stretch to them: at hd 256 a warp of 16 rows
// would hold Q's fragments (128 registers, 256 split) beside its O
// accumulators (128), and 128 query rows' K/V stages take ~335 KB. This
// kernel keeps that design's arithmetic and reshapes the work:
//   * 8 warps a CTA, one CTA an SM (launch bounds (256, 1)): 8 warps on
//     each SM at both head dims, in both types. A block of 16 query rows
//     belongs to one warp at hd 96 (128 rows a CTA) and to a pair of warps
//     at hd 256 (64 rows a CTA): each warp of the pair owns hd / 2 of the
//     columns, both of Q (half of the Q K^T contraction) and of O (64
//     accumulators, not 128). The pair adds its two partial score tiles
//     through shared memory (one slot a warp, in slot order, a named
//     barrier for the two warps), so both run the same softmax on the same
//     bits, and each multiplies P by its own half of V.
//   * Q stays in registers, scaled by 1/sqrt(hd) (fp32) or widened (bf16,
//     exact in tf32, scaled on the scores). fp32 at hd 96 splits it once,
//     into the tf32 hi fragment and the bf16 [hi | lo] fragment (96
//     registers). At hd 256 a warp keeps its 64 raw values and splits them
//     at each k-step: split once (128 registers), or its lo words kept in
//     shared memory, the kernel spilled 12-32 bytes at 255 registers.
//   * fp32 K and V are split once a tile, when the tile lands: tf32 hi in
//     place, and a bf16 lo plane (K: lo of two head columns a word; V: lo
//     of two keys a word, the pairs of the B fragment). The bf16 word of hi
//     that the correction product takes is one cvt of the hi pair the tf32
//     fragment has just read, so the lo plane is half the size of hi.
//     tf32 rounding is two integer instructions (tf32_rna): on sm_90 the
//     cvt.rna.tf32.f32 of the design above compiles to four.
//   * fp32: two tensor-core instructions for each 8-deep step, as above:
//     hi hi as tf32 m16n8k8 and hi lo + lo hi as one bf16 m16n8k16 over
//     [hi | lo] against [lo ; hi]. That is chip_smoke.py's
//     flash_tensor_ops, the kernel's bound. bf16 inputs are exact in tf32
//     and read raw bf16 rows (widened by a shift): Q K^T one tf32 product,
//     P V two (P's hi and lo against V).
//   * Copies: a ring of 3 K/V stages filled by cp.async (16-byte, .cg;
//     rows past Sk zero-filled). Iteration i starts the copy of tile
//     i + 2 into the stage that tile i - 1 freed, waits for tile i + 1's
//     (each thread its own chunks), splits it (fp32; V's rows in pairs) and
//     multiplies tile i; one __syncthreads a tile publishes tile i + 1 and
//     frees tile i's stage and lo plane set. So the copies run 2 tiles
//     ahead, and every stage is live on every iteration.
//     Tiles are 16 keys for fp32 at hd 256 and 32 otherwise.
//   * Softmax and products overlap across warps: the two warps of an SM
//     sub-partition take turns on the tensor pipe. Overlap inside a warp
//     (running one tile ahead, the next tile's scores under this one's
//     softmax; or the softmax in two halves) measured no faster at hd 96
//     and 2-4 % slower at hd 256 on the card (PERF.md §6): its
//     registers cost more than it hides. The rescale of O is skipped when
//     no row's max moved (a factor of exactly 1).
//   * The masks (tiles outside a block's band skipped, the per-element mask
//     only on the band's edge tiles), the rows that see no key, the online
//     softmax, the permuted k of the tf32 fragments (P's accumulators are
//     P V's A fragment as they stand) and the output are those above.
//     Positions are 32-bit (the launch refuses lengths from 2^30).
//   * Fragment reads are free of bank conflicts: K hi at row stride hd + 8
//     words (8-byte pairs), V hi at hd + 4, K lo at hd / 2 + 4, V lo at
//     hd + 8; bf16 rows at hd + 8 elements.
// Shared memory (WideLayout::kBytes; the wrapper's flash_attention.layout
// gives the same numbers and this source refuses any other): 3 stages of
// hi planes (or raw bf16 rows), 2 fp32 lo plane sets, the exchange slots
// (hd 256): fp32 hd 96 104,960 bytes, hd 256 142,592; bf16 39,936 and
// 117,760. Above the 48 KB default, hence cudaFuncSetAttribute.
//
// Why mma.sync and not wgmma: wgmma's tf32 form takes B K-major only (V
// needs a transposed copy), and its descriptors and swizzled layouts could
// not be tried off the card within this design's budget; the kernel runs
// well below mma.sync's ~260 TFLOP/s of tf32 on this card (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kWWarps = 8;
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWStages = 3;   // K/V tiles in the cp.async ring
constexpr int kWAhead = kWStages - 1;   // tiles the copies run ahead of the products

template <typename T, int HD>
struct WideLayout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kSplit = HD == 256 ? 2 : 1;        // warps sharing a 16-row block
  static constexpr int kCols = HD / kSplit;               // a warp's columns of Q and O
  static constexpr int kRows = 16 * kWWarps / kSplit;     // query rows a CTA
  static constexpr int kBK = kF32 && HD == 256 ? 16 : 32; // keys a K/V tile
  static constexpr int kNT = kBK / 8;                     // score n-tiles a tile
  static constexpr bool kQSplit = kF32 && HD == 96;       // Q split once, in registers
  // fp32 row strides, in words: K hi, V hi, K lo (a bf16 pair of columns a
  // word), V lo (a row a pair of keys, a bf16 pair of keys a word)
  static constexpr int KS = HD + 8, VS = HD + 4, LKS = HD / 2 + 4, LVS = HD + 8;
  static constexpr int RS = HD + 8;   // bf16 row stride, in elements
  static constexpr int kKS = kF32 ? KS : RS;   // K's row stride in a stage, in T
  static constexpr size_t kStageBytes =
      kF32 ? 4 * size_t(kBK) * (KS + VS) : 2 * 2 * size_t(kBK) * RS;
  static constexpr size_t kLoBytes = kF32 ? 4 * (size_t(kBK) * LKS + size_t(kBK / 2) * LVS) : 0;
  static constexpr int kLoSets = kF32 ? 2 : 0;   // fp32 lo plane sets: tiles i, i + 1
  static constexpr size_t kXBytes = kSplit > 1 ? 4 * size_t(kWWarps) * 16 * kBK : 0;
  static constexpr size_t kBytes = kWStages * kStageBytes + kLoSets * kLoBytes + kXBytes;
  static_assert(HD % 32 == 0 && kCols % 8 == 0, "conflict-free strides, whole k-steps");
  static_assert(kBytes <= 232448, "shared memory over a block's 227 KB");
};

// tf32(x) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 gives
// it for every finite x, in two integer instructions: on sm_90 the cvt
// compiles to four, a guard for inf and NaN among them. A NaN or inf x
// still ends as a NaN product: lo = x - hi is NaN.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// q_frags with tf32_rna: the tf32 hi fragment and the bf16 [hi | lo] fragment
// of four values x = (A[g][k], A[g+8][k], A[g][k'], A[g+8][k'])
__device__ __forceinline__ void wide_frags(const float (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&corr)[4]) {
  float lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(x[e]);
    lo[e] = x[e] - __uint_as_float(hi[e]);
  }
  corr[0] = pack_bf16(__uint_as_float(hi[0]), __uint_as_float(hi[2]));
  corr[1] = pack_bf16(__uint_as_float(hi[1]), __uint_as_float(hi[3]));
  corr[2] = pack_bf16(lo[0], lo[2]);
  corr[3] = pack_bf16(lo[1], lo[3]);
}

// x and y split as tf32 hi (returned in place) and their lo in bf16, one word
__device__ __forceinline__ uint32_t wide_split2(float& x, float& y) {
  const float hx = __uint_as_float(tf32_rna(x)), hy = __uint_as_float(tf32_rna(y));
  const uint32_t w = pack_bf16(x - hx, y - hy);
  x = hx;
  y = hy;
  return w;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the named barrier of the N warps of a block of rows (ids 1..4; 0 is
// __syncthreads)
template <int N>
__device__ __forceinline__ void block_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(32 * N) : "memory");
}

// Start the copy of keys [k0, k0 + kBK) of K and V into one stage: fp32 into
// the padded hi planes, bf16 into padded raw rows. fp32 copies V's rows in
// pairs (2 rp, 2 rp + 1) at one column chunk, since its split pairs keys.
template <typename T, int HD>
__device__ __forceinline__ void wide_issue(T* st, const T* kb, const T* vb, int k0, int sk) {
  using L = WideLayout<T, HD>;
  constexpr int kE = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int kCPR = HD / kE;        // chunks per row
  constexpr int kVS = L::kF32 ? L::VS : L::RS;
  T* vdst = st + L::kBK * L::kKS;
#pragma unroll
  for (int f = threadIdx.x; f < L::kBK * kCPR; f += kWThreads) {
    const int r = f / kCPR;
    const int c = (f % kCPR) * kE;
    const bool ok = k0 + r < sk;
    cp_async16(st + r * L::kKS + c, kb + static_cast<long long>(ok ? k0 + r : 0) * HD + c, ok);
  }
#pragma unroll
  for (int f = threadIdx.x; f < L::kBK / 2 * kCPR; f += kWThreads) {
    const int rp = f / kCPR;
    const int c = (f % kCPR) * kE;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = L::kF32 ? 2 * rp + s : rp + s * (L::kBK / 2);
      const bool ok = k0 + r < sk;
      cp_async16(vdst + r * kVS + c, vb + static_cast<long long>(ok ? k0 + r : 0) * HD + c, ok);
    }
  }
}

// Split the chunks this thread copied (after its cp.async.wait_group): each
// value to tf32 hi in place, and lo = x - hi (exact) in bf16 into the lo
// planes: K's (row r, columns c, c + 1) at word r * LKS + c / 2, V's (keys
// 2 rp, 2 rp + 1; column c) at word rp * LVS + c.
template <int HD>
__device__ __forceinline__ void wide_split(float* st, uint32_t* lo) {
  using L = WideLayout<float, HD>;
  constexpr int kCPR = HD / 4;
  float* vh = st + L::kBK * L::KS;
  uint32_t* vl = lo + L::kBK * L::LKS;
#pragma unroll
  for (int f = threadIdx.x; f < L::kBK * kCPR; f += kWThreads) {
    const int r = f / kCPR;
    const int c = (f % kCPR) * 4;
    float4* p = reinterpret_cast<float4*>(st + r * L::KS + c);
    float4 x = *p;
    uint2 w;
    w.x = wide_split2(x.x, x.y);
    w.y = wide_split2(x.z, x.w);
    *p = x;
    *reinterpret_cast<uint2*>(lo + r * L::LKS + c / 2) = w;
  }
#pragma unroll
  for (int f = threadIdx.x; f < L::kBK / 2 * kCPR; f += kWThreads) {
    const int rp = f / kCPR;
    const int c = (f % kCPR) * 4;
    float4* p0 = reinterpret_cast<float4*>(vh + 2 * rp * L::VS + c);
    float4* p1 = reinterpret_cast<float4*>(vh + (2 * rp + 1) * L::VS + c);
    float4 x0 = *p0, x1 = *p1;
    uint4 w;
    w.x = wide_split2(x0.x, x1.x);
    w.y = wide_split2(x0.y, x1.y);
    w.z = wide_split2(x0.z, x1.z);
    w.w = wide_split2(x0.w, x1.w);
    *p0 = x0;
    *p1 = x1;
    *reinterpret_cast<uint4*>(vl + rp * L::LVS + c) = w;
  }
}

// One tile as a warp reads it: its planes and the masks' arguments.
struct WideTile {
  const void* K;        // K rows (fp32: hi plane; bf16: raw)
  const void* V;
  const uint32_t* Kl;   // fp32 lo planes
  const uint32_t* Vl;
  int k0;
  Mode mode;            // for this warp's block of rows
};

// What stays the same over a warp's walk.
struct WideRows {
  float4* xblk;         // the block's exchange slots, one a warp (hd 256)
  int part;             // this warp's slot
  int ra, sk, window;   // positions: the wrapper keeps lengths below 2^30
  int causal, has_window, g, t, col0, bar;
  float scale;          // applied to the scores of bf16 inputs
};

// The warp's partial S = Q K^T over its columns, every n-tile of the tile;
// n-tile j holds
// (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of keys 8 j ...
template <typename T, int HD, int QLR>
__device__ __forceinline__ void wide_scores(float (&s)[WideLayout<T, HD>::kNT][4],
                                            const uint32_t (&qa)[WideLayout<T, HD>::kCols / 8][4],
                                            const uint32_t (&qc)[QLR][4], const WideTile& tile,
                                            const WideRows& w) {
  using L = WideLayout<T, HD>;
  constexpr bool kF32 = L::kF32;
#pragma unroll
  for (int j = 0; j < L::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // this lane's first K words: key g, columns col0 + 2t, + 1 (hi; fp32 lo
  // word col0 / 2 + t); k-step ks and n-tile j add constant offsets
  const int kcol = w.col0 + 2 * w.t;
  const float* kh = static_cast<const float*>(tile.K) + w.g * L::KS + kcol;
  const uint32_t* kl = tile.Kl + w.g * L::LKS + kcol / 2;
  const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(tile.K) + w.g * L::RS + kcol;
#pragma unroll
  for (int ks = 0; ks < L::kCols / 8; ++ks) {
    uint32_t ah[4], ac[4];
    if constexpr (L::kQSplit) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = qa[ks][e];
        ac[e] = qc[ks][e];
      }
    } else if constexpr (kF32) {
      // split here, in the tile loop: hoisted out of it, both fragments
      // would take 128 registers (the volatile asm keeps it here)
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t raw = qa[ks][e];
        asm volatile("" : "+r"(raw));
        x[e] = __uint_as_float(raw);
      }
      wide_frags(x, ah, ac);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[e] = qa[ks][e];
    }
#pragma unroll
    for (int j = 0; j < L::kNT; ++j) {
      if constexpr (kF32) {
        const uint2 bh = *reinterpret_cast<const uint2*>(kh + 8 * j * L::KS + 8 * ks);
        const uint32_t bl = kl[8 * j * L::LKS + 4 * ks];
        mma_bf16(s[j], ac, bl, pack_bf16(__uint_as_float(bh.x), __uint_as_float(bh.y)));
        mma(s[j], ah, bh.x, bh.y);
      } else {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(kr + 8 * j * L::RS + 8 * ks);
        mma(s[j], ah, b << 16, b & 0xffff0000u);
      }
    }
  }
}

// hd 256: the block's partial tiles, added in slot order in every warp of
// the block (the same bits in each)
template <typename T, int HD>
__device__ __forceinline__ void wide_exchange(float (&s)[WideLayout<T, HD>::kNT][4],
                                              const WideRows& w) {
  using L = WideLayout<T, HD>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < L::kNT; ++j)
    w.xblk[(w.part * L::kNT + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  block_sync<L::kSplit>(w.bar);
#pragma unroll
  for (int j = 0; j < L::kNT; ++j) {
    float4 x = w.xblk[j * 32 + lane];
#pragma unroll
    for (int p = 1; p < L::kSplit; ++p) {
      const float4 y = w.xblk[(p * L::kNT + j) * 32 + lane];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    s[j][0] = x.x;
    s[j][1] = x.y;
    s[j][2] = x.z;
    s[j][3] = x.w;
  }
}

// The masks (edge tiles only), the online softmax of rows g and g + 8 over
// the tile, and O += P V over the warp's columns.
template <typename T, int HD, bool MASKED>
__device__ __forceinline__ void wide_softmax_pv(float (&s)[WideLayout<T, HD>::kNT][4],
                                                float (&m)[2], float (&l)[2],
                                                float (&acc)[WideLayout<T, HD>::kCols / 8][4],
                                                const WideTile& tile, const WideRows& w) {
  using L = WideLayout<T, HD>;
  constexpr bool kF32 = L::kF32;
  float rmax[2] = {kMaskFill, kMaskFill};
#pragma unroll
  for (int j = 0; j < L::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kF32 ? s[j][e] : s[j][e] * w.scale;
      if constexpr (MASKED) {
        const int qi = w.ra + w.g + 8 * (e >> 1);
        const int ki = tile.k0 + 8 * j + 2 * w.t + (e & 1);
        const bool visible = ki < w.sk && (!w.causal || ki <= qi) &&
                             (!w.has_window || qi - ki < w.window);
        x = visible ? x : kMaskFill;
      }
      s[j][e] = x;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m_new = fmaxf(m[rr], quad_max(rmax[rr]));
    alpha[rr] = expf(m[rr] - m_new);
    m[rr] = m_new;
    l[rr] *= alpha[rr];
  }
#pragma unroll
  for (int j = 0; j < L::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(s[j][e] - m[e >> 1]);
      if constexpr (MASKED) {
        if (tile.k0 + 8 * j + 2 * w.t + (e & 1) >= w.sk) p = 0.f;
      }
      s[j][e] = p;
      l[e >> 1] += p;
    }
  // alpha is exactly 1 for a row whose max did not move: skip the rescale
  // when that holds for every row of the warp
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < L::kCols / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
  }
#pragma unroll
  for (int j = 0; j < L::kNT; ++j) {
    const int row = 8 * j + 2 * w.t;   // keys 2t and 2t + 1 of the n-tile
    uint32_t ph[4], pc[4];
    if constexpr (kF32) {
      wide_frags({s[j][0], s[j][2], s[j][1], s[j][3]}, ph, pc);
      const float* v0 = static_cast<const float*>(tile.V) + row * L::VS + w.col0 + w.g;
      const uint32_t* w0 = tile.Vl + (row / 2) * L::LVS + w.col0 + w.g;
#pragma unroll
      for (int n = 0; n < L::kCols / 8; ++n) {
        const float b0 = v0[8 * n], b1 = v0[L::VS + 8 * n];
        mma_bf16(acc[n], pc, w0[8 * n], pack_bf16(b0, b1));
        mma(acc[n], ph, __float_as_uint(b0), __float_as_uint(b1));
      }
    } else {
      // V is exact in tf32: P's two parts against it
      const float x[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[e] = tf32_rna(x[e]);
        pl[e] = tf32_rna(x[e] - __uint_as_float(ph[e]));
      }
      const unsigned short* v0 = reinterpret_cast<const unsigned short*>(tile.V) +
                                 row * L::RS + w.col0 + w.g;
#pragma unroll
      for (int n = 0; n < L::kCols / 8; ++n) {
        const uint32_t b0 = uint32_t(v0[8 * n]) << 16;
        const uint32_t b1 = uint32_t(v0[L::RS + 8 * n]) << 16;
        mma(acc[n], pl, b0, b1);
        mma(acc[n], ph, b0, b1);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int H, int group, long long sq, long long sk, int causal,
                  int has_window, long long window, float scale) {
  using L = WideLayout<T, HD>;
  constexpr bool kF32 = L::kF32;
  constexpr int kBK = L::kBK;
  constexpr int kNT = L::kNT;
  constexpr int kDK = L::kCols / 8;          // k-steps of Q K^T, n-tiles of O, a warp
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // tile i sits in stage i % kWStages and (fp32) lo plane set i % 2; the exchange
  // slots follow
  auto stage = [&](int i) {
    return reinterpret_cast<T*>(smem + (i % kWStages) * L::kStageBytes);
  };
  auto lo_set = [&](int i) {
    return reinterpret_cast<uint32_t*>(smem + kWStages * L::kStageBytes + (i & 1) * L::kLoBytes);
  };
  float4* xslots =
      reinterpret_cast<float4*>(smem + kWStages * L::kStageBytes + L::kLoSets * L::kLoBytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int blk = warp / L::kSplit;          // the warp's block of 16 query rows
  const int col0 = (warp % L::kSplit) * L::kCols;
  const long long h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long kv_head = b * (H / group) + h / group;
  const T* qb = q + (b * H + h) * sq * HD;
  const T* kb = k + kv_head * sk * HD;
  const T* vb = v + kv_head * sk * HD;
  T* ob = o + (b * H + h) * sq * HD;
  // positions in 32 bits (the launch refuses lengths from 2^30); a window
  // wider than Sq masks nothing and blinds no row, as Sq does
  const int nq = static_cast<int>(sq), nk = static_cast<int>(sk);
  const int win = !has_window || window < 1 ? 0 : window > sq ? nq : static_cast<int>(window);
  const int q0 = static_cast<int>(gridDim.z - 1 - blockIdx.z) * L::kRows;

  auto key_lo = [&](int qi) { return has_window && qi - win + 1 > 0 ? qi - win + 1 : 0; };
  auto key_hi = [&](int qi) { return causal && qi < nk - 1 ? qi : nk - 1; };
  // row qi sees no key: qi >= Sk + window - 1
  auto is_blind = [&](int qi) { return has_window && (win < 1 || qi - win + 1 >= nk); };
  const int q_last = (q0 + L::kRows < nq ? q0 + L::kRows : nq) - 1;
  int k_begin = 0, k_end = nk;
  if (!is_blind(q_last)) {
    k_begin = key_lo(q0);
    k_end = key_hi(q_last) + 1;
  }
  const int ra = q0 + 16 * blk;
  const int rz = (ra + 15 < nq ? ra + 15 : nq - 1);
  const bool blind = is_blind(rz);

  // the first kWAhead tiles' copies start before Q is loaded
  const int tile0 = k_begin / kBK;
  const int ntiles = (k_end + kBK - 1) / kBK - tile0;
#pragma unroll
  for (int i = 0; i < kWAhead; ++i) {
    if (i < ntiles) wide_issue<T, HD>(stage(i), kb, vb, (tile0 + i) * kBK, nk);
    cp_async_commit();
  }

  // Q fragments of this lane: rows ra + g and ra + g + 8, columns
  // col0 + 8 ks + 2t, + 1 (the permuted k: a0 / a2 hold 2t / 2t + 1 of row g)
  uint32_t qa[kDK][4];
  uint32_t qc[L::kQSplit ? kDK : 1][4];
  {
    const int r0 = ra + g, r1 = ra + g + 8;
    const float qs = kF32 ? scale : 1.f;
#pragma unroll
    for (int ks = 0; ks < kDK; ++ks) {
      const int d = col0 + 8 * ks + 2 * t;
      const float2 x0 = r0 < nq ? load2(qb + static_cast<long long>(r0) * HD + d)
                                : make_float2(0.f, 0.f);
      const float2 x1 = r1 < nq ? load2(qb + static_cast<long long>(r1) * HD + d)
                                : make_float2(0.f, 0.f);
      const float x[4] = {x0.x * qs, x1.x * qs, x0.y * qs, x1.y * qs};
      if constexpr (L::kQSplit) {
        wide_frags(x, qa[ks], qc[ks]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[ks][e] = __float_as_uint(x[e]);
      }
    }
  }

  const WideRows rows = {xslots + 32 * kNT * L::kSplit * blk, warp % L::kSplit, ra, nk, win,
                         causal, has_window, g, t, col0, 1 + blk, scale};
  float m[2] = {kMaskFill, kMaskFill};
  float l[2] = {0.f, 0.f};
  float acc[kDK][4];
#pragma unroll
  for (int n = 0; n < kDK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait<kWAhead - 1>();
  if constexpr (kF32) {
    if (ntiles > 0) wide_split<HD>(stage(0), lo_set(0));
  }
  __syncthreads();

  for (int i = 0; i < ntiles; ++i) {
    if (i + kWAhead < ntiles)
      wide_issue<T, HD>(stage(i + kWAhead), kb, vb, (tile0 + i + kWAhead) * kBK, nk);
    cp_async_commit();
    cp_async_wait<kWAhead - 1>();
    // past the last tile, a stage that is not in use is split again to no
    // effect (tf32 rounding is idempotent; the lo set it writes is free),
    // which keeps the split unconditional
    if constexpr (kF32) wide_split<HD>(stage(i + 1), lo_set(i + 1));
    T* st = stage(i);
    const uint32_t* lo = lo_set(i);
    WideTile tile = {st, st + kBK * L::kKS, lo, lo + kBK * L::LKS, (tile0 + i) * kBK, kEdge};
    const int kz = tile.k0 + kBK - 1;
    if (ra >= nq) {
      tile.mode = kSkip;
    } else if (!blind) {
      if (tile.k0 > key_hi(rz) || kz < key_lo(ra))
        tile.mode = kSkip;
      else if (kz < nk && key_lo(rz) <= tile.k0 && kz <= key_hi(ra))
        tile.mode = kFull;
    }
    if (tile.mode != kSkip) {
      float s[kNT][4];
      wide_scores<T, HD>(s, qa, qc, tile, rows);
      if constexpr (L::kSplit > 1) wide_exchange<T, HD>(s, rows);
      if (tile.mode == kFull)
        wide_softmax_pv<T, HD, false>(s, m, l, acc, tile, rows);
      else
        wide_softmax_pv<T, HD, true>(s, m, l, acc, tile, rows);
    }
    __syncthreads();   // tile i + 1 is split; tile i's stage, lo set and the slots are free
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = ra + g + 8 * rr;
    const float denom = fmaxf(quad_sum(l[rr]), 1e-30f);
    if (qi >= nq) continue;
#pragma unroll
    for (int n = 0; n < kDK; ++n)
      store2(ob + static_cast<long long>(qi) * HD + col0 + 8 * n + 2 * t,
             acc[n][2 * rr] / denom, acc[n][2 * rr + 1] / denom);
  }
}

// The launch configuration of one head dim and type: flash_wide_kernel at
// the wide head dims, else flash_fwd_kernel.
struct Config {
  int rows, warps;
  long long smem;
};

template <typename T, int HD>
constexpr Config config() {
  if constexpr (HD == 96 || HD == 256)
    return {WideLayout<T, HD>::kRows, kWWarps, static_cast<long long>(WideLayout<T, HD>::kBytes)};
  else
    return {kBQ, kWarps, static_cast<long long>(Layout<T, HD>::kBytes)};
}

template <typename T>
using KernelT = void (*)(const T*, const T*, const T*, T*, int, int, long long, long long, int,
                         int, long long, float);

template <typename T, int HD>
KernelT<T> kernel_of() {
  if constexpr (HD == 96 || HD == 256)
    return flash_wide_kernel<T, HD>;
  else
    return flash_fwd_kernel<T, HD>;
}

// one grid (H, B, query tiles) of the head dim's kernel, after checking the
// caller's layout (rows, warps, shared bytes) against this source's
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
           long long KV, long long sq, long long sk, int causal, int has_window,
           long long window, float scale, int rows, int warps, long long smem,
           cudaStream_t stream) {
  constexpr Config c = config<T, HD>();
  if (rows != c.rows || warps != c.warps || smem != c.smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (sq + c.rows - 1) / c.rows;
  if (B >= 65536 || tiles >= 65536 || H >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((HD == 96 || HD == 256) && (sq >= (1LL << 30) || sk >= (1LL << 30)))
    return static_cast<int>(cudaErrorInvalidValue);   // flash_wide_kernel's 32-bit positions
  const KernelT<T> kernel = kernel_of<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, 32 * c.warps, c.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<int>(H), static_cast<int>(H / KV), sq, sk, causal,
      has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// what the card makes of the head dim's kernel: CTAs an SM, registers and
// local (spill) bytes a thread, threads a CTA
template <typename T, int HD>
int occupancy(int* out) {
  constexpr Config c = config<T, HD>();
  const void* kernel = reinterpret_cast<const void*>(kernel_of<T, HD>());
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * c.warps,
                                                      static_cast<size_t>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = 32 * c.warps;
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// q: (B,H,sq,hd), k/v: (B,KV,sk,hd), o: (B,H,sq,hd); fp32 (bf16 = 0) or bf16
// (bf16 = 1); hd 64 or 128 (flash_fwd_kernel) or 96 or 256 (flash_wide_kernel);
// window used when has_window; scale = 1/sqrt(hd); rows, warps, smem: the
// caller's layout of the kernel (flash_attention.layout), refused unless it is
// this source's. B < 65536 and the query tiles ceil(sq / rows) < 65536 (the
// grid's y and z): rows is 128 at hd 64, 96 and 128, and 64 at hd 256.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long B, long long H, long long KV, long long sq,
                        long long sk, long long hd, int bf16, int causal,
                        int has_window, long long window, float scale, int rows, int warps,
                        long long smem, void* stream) {
  if (B <= 0 || H <= 0 || sq <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(T, HD)                                                                   \
  launch<T, HD>(q, k, v, o, B, H, KV, sq, sk, causal, has_window, window, scale, rows, warps, \
                smem, s)
  switch (hd) {
    case 64: return bf16 ? FLASH_LAUNCH(__nv_bfloat16, 64) : FLASH_LAUNCH(float, 64);
    case 96: return bf16 ? FLASH_LAUNCH(__nv_bfloat16, 96) : FLASH_LAUNCH(float, 96);
    case 128: return bf16 ? FLASH_LAUNCH(__nv_bfloat16, 128) : FLASH_LAUNCH(float, 128);
    case 256: return bf16 ? FLASH_LAUNCH(__nv_bfloat16, 256) : FLASH_LAUNCH(float, 256);
  }
#undef FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..3]: CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
// kernel's threads and shared bytes), registers a thread, local bytes a thread
// (spills; cudaFuncGetAttributes), threads a CTA
int flash_attention_occupancy(long long hd, int bf16, int* out) {
  switch (hd) {
    case 64: return bf16 ? occupancy<__nv_bfloat16, 64>(out) : occupancy<float, 64>(out);
    case 96: return bf16 ? occupancy<__nv_bfloat16, 96>(out) : occupancy<float, 96>(out);
    case 128: return bf16 ? occupancy<__nv_bfloat16, 128>(out) : occupancy<float, 128>(out);
    case 256: return bf16 ? occupancy<__nv_bfloat16, 256>(out) : occupancy<float, 256>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
