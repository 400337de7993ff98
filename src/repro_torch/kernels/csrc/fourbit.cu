// 4-bit codebook kernels (fp4 / nf4) for Hopper (sm_90a): quantize and
// dequantize over 64-element absmax blocks, two codes per byte.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant_nf4.py  quantize_4bit_pallas   (_make_quant_kernel)
//   src/repro/kernels/quant_nf4.py  dequantize_4bit_pallas (_make_dequant_kernel)
//
// Both are bound by device memory. Quantize reads 4 bytes and writes half a
// byte per element (plus 4 bytes of absmax per 64 elements); dequantize reads
// half a byte and writes 4. The float work per element is a few operations and
// the code search, well under the fp32 rate for the bytes moved — as long as
// the search stays short, which is why it is a binary search (below).
//
// Design. The TPU kernel tiles 256 blocks per grid step; here a block is small
// enough to live in one half-warp, and both kernels work in units of 4 adjacent
// elements (2 packed bytes) per thread. Each thread takes kUnits such units, a
// CTA width apart, and issues all its loads before it computes, so a warp keeps
// several loads in flight (one unit each left the load latency exposed):
//   quantize4:   16 lanes per 64-element block, each lane one 16-byte float4
//                load per unit, so a warp covers 2 blocks a unit and its
//                2-byte stores are contiguous. The block's absmax is a shuffle
//                max over the 16-lane half (offsets 8, 4, 2, 1); lane 0 of each
//                half writes it. An element's code is the number of fp32
//                midpoints it lies strictly above — found by a 4-step binary
//                search over the 15 ascending midpoints (the first pivot a
//                kernel argument, the rest in shared memory, 15 words in 15
//                banks, so the lanes' lookups never conflict), which equals the
//                reference's count of 15 compares because the midpoints ascend
//                — mapped to the codebook index through the rank -> index
//                permutation, packed 4 bits per entry in one 64-bit argument (a
//                register shift).
//   dequantize4: 4 output elements a unit: a 2-byte load gives 4 codes,
//                written as one float4, so a warp's loads and stores are both
//                contiguous. The codebook is copied into shared memory once
//                per CTA (16 entries in 16 banks).
// Indices are 64-bit: the fused group of a full llama3.2-1b message is 23.4 M
// blocks, 375 M units. The grid covers any block count; units past the end are
// masked (masked lanes still join the barrier and the shuffles).
//
// Numerics are pinned to the reference's live arithmetic: inv = 1/absmax is a
// correctly rounded __fdiv_rn (0 for an all-zero block), xn = __fmul_rn(x, inv),
// the compares are strict (xn > mid) against midpoints formed in fp32 on the
// host, nibble order puts the even element in the high nibble, dequantize is
// one __fmul_rn(code[idx], absmax), which keeps FP4's -0.0 entries, and every
// step flushes subnormals (common.cuh). The build uses -fmad=false; do not
// build with --use_fast_math. The absmax keeps NaN (an unsigned max of
// abs_bits): a block holding NaN gets absmax NaN and inv 0 (NaN > 0 is false),
// as in the reference.
//
// Plain C interface (loaded with ctypes): raw device pointers, host pointers to
// the codebook, its midpoints and its permutation (copied into the kernel's
// by-value argument), and a cudaStream_t. Launches on that stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads4 = 256;      // threads per CTA
constexpr int kUnits = 4;           // 4-element units per thread, kThreads4 apart
constexpr int kLanesPerBlock = 16;  // units per 64-element block

struct Codebook4 {
  float code[16];       // the codebook in index order
  float mids[15];       // ascending fp32 midpoints of the sorted codebook
  uint64_t perm;        // rank r -> code index in bits [4r, 4r + 4)
};

// rank = #{i : xn > mids[i]}: the predicate holds for a prefix of the
// ascending midpoints, so four halving steps find its length (0..15)
__device__ __forceinline__ uint32_t code_index(float xn, float mid7, const float* mids,
                                               uint64_t perm) {
  int pos = xn > mid7 ? 8 : 0;
  pos += xn > mids[pos + 3] ? 4 : 0;
  pos += xn > mids[pos + 1] ? 2 : 0;
  pos += xn > mids[pos] ? 1 : 0;
  return static_cast<uint32_t>(perm >> (4 * pos)) & 0xFu;
}

// x: nquads float4 units (16 per block) -> packed: nquads 2-byte units
__global__ void __launch_bounds__(kThreads4)
quantize4_kernel(const float4* __restrict__ x, uint16_t* __restrict__ packed,
                 float* __restrict__ absmax, long long nquads, Codebook4 cb) {
  __shared__ float mids[16];
  if (threadIdx.x < 15) mids[threadIdx.x] = cb.mids[threadIdx.x];
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads4 * kUnits) +
                          threadIdx.x;
  float4 v[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long t = first + k * kThreads4;
    v[k] = t < nquads ? ftz4(x[t]) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float mid7 = cb.mids[7];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long t = first + k * kThreads4;   // a block's 16 units share validity
    // the bits of max |x| (abs_bits: NaN wins)
    unsigned mb = max(max(abs_bits(v[k].x), abs_bits(v[k].y)),
                      max(abs_bits(v[k].z), abs_bits(v[k].w)));
#pragma unroll
    for (int off = kLanesPerBlock / 2; off > 0; off >>= 1) {
      mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    const float m = __uint_as_float(mb);
    if (t < nquads) {
      const float inv = m > 0.f ? ftz(__fdiv_rn(1.f, m)) : 0.f;
      const uint32_t i0 = code_index(ftz(__fmul_rn(v[k].x, inv)), mid7, mids, cb.perm);
      const uint32_t i1 = code_index(ftz(__fmul_rn(v[k].y, inv)), mid7, mids, cb.perm);
      const uint32_t i2 = code_index(ftz(__fmul_rn(v[k].z, inv)), mid7, mids, cb.perm);
      const uint32_t i3 = code_index(ftz(__fmul_rn(v[k].w, inv)), mid7, mids, cb.perm);
      // byte 2l holds elements (4l, 4l+1), byte 2l+1 elements (4l+2, 4l+3);
      // little-endian, so the first byte is the low half of the 16-bit store
      packed[t] = static_cast<uint16_t>(((i0 << 4) | i1) | (((i2 << 4) | i3) << 8));
      if ((threadIdx.x & (kLanesPerBlock - 1)) == 0) absmax[t / kLanesPerBlock] = m;
    }
  }
}

// packed: nquads 2-byte units (16 per block) -> out: nquads float4 units
__global__ void __launch_bounds__(kThreads4)
dequantize4_kernel(const uint16_t* __restrict__ packed, const float* __restrict__ absmax,
                   float4* __restrict__ out, long long nquads, Codebook4 cb) {
  __shared__ float code[16];
  if (threadIdx.x < 16) code[threadIdx.x] = cb.code[threadIdx.x];
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads4 * kUnits) +
                          threadIdx.x;
  uint32_t w[kUnits];
  float s[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long t = first + k * kThreads4;
    w[k] = t < nquads ? packed[t] : 0u;
    s[k] = t < nquads ? ftz(absmax[t / kLanesPerBlock]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long t = first + k * kThreads4;
    if (t >= nquads) break;
    // byte j = bits [8j, 8j + 8): high nibble is element 2j, low nibble 2j + 1
    float4 o;
    o.x = ftz(__fmul_rn(code[(w[k] >> 4) & 0xFu], s[k]));
    o.y = ftz(__fmul_rn(code[w[k] & 0xFu], s[k]));
    o.z = ftz(__fmul_rn(code[(w[k] >> 12) & 0xFu], s[k]));
    o.w = ftz(__fmul_rn(code[(w[k] >> 8) & 0xFu], s[k]));
    out[t] = o;
  }
}

Codebook4 make_codebook(const float* code, const float* mids, const int* perm) {
  Codebook4 cb;
  cb.perm = 0;
  for (int i = 0; i < 16; ++i) {
    cb.code[i] = code[i];
    cb.perm |= static_cast<uint64_t>(perm[i] & 0xF) << (4 * i);
  }
  for (int i = 0; i < 15; ++i) cb.mids[i] = mids[i];
  return cb;
}

unsigned grid_for(long long nquads) {
  constexpr long long per_cta = static_cast<long long>(kThreads4) * kUnits;
  return static_cast<unsigned>((nquads + per_cta - 1) / per_cta);
}

}  // namespace

extern "C" {

// x: (nblocks, 64) f32 -> packed: (nblocks, 32) uint8, absmax: (nblocks,) f32.
// code (16), mids (15), perm (16): host arrays of the format's codebook.
int fb4_quantize(const void* x, void* packed, void* absmax, long long nblocks,
                 const float* code, const float* mids, const int* perm,
                 void* stream) {
  if (nblocks > 0) {
    const long long nquads = nblocks * kLanesPerBlock;
    quantize4_kernel<<<grid_for(nquads), kThreads4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<uint16_t*>(packed),
        static_cast<float*>(absmax), nquads, make_codebook(code, mids, perm));
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: (nblocks, 32) uint8, absmax: (nblocks,) f32 -> out: (nblocks, 64) f32
int fb4_dequantize(const void* packed, const void* absmax, void* out,
                   long long nblocks, const float* code, const float* mids,
                   const int* perm, void* stream) {
  if (nblocks > 0) {
    const long long nquads = nblocks * kLanesPerBlock;
    dequantize4_kernel<<<grid_for(nquads), kThreads4, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(packed), static_cast<const float*>(absmax),
        static_cast<float4*>(out), nquads, make_codebook(code, mids, perm));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
