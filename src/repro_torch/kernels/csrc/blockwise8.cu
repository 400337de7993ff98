// Blockwise-int8 kernels for Hopper (sm_90a): quantize, dequantize, the
// server's in-place streaming fold and the K-way dequantize-and-sum of the
// cross-pod collective.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant_blockwise8.py  quantize_blockwise8_pallas   (_quantize_kernel)
//   src/repro/kernels/quant_blockwise8.py  dequantize_blockwise8_pallas (_dequantize_kernel)
//   src/repro/kernels/fused_dequant_agg.py dequant_accumulate8_into_pallas (_fold_kernel)
//   src/repro/kernels/fused_dequant_agg.py dequant_accumulate8_pallas   (_agg_kernel)
//
// All four are bound by device memory: a handful of float operations per
// element against 5 bytes (quantize, dequantize), 9 bytes (fold) or K + 4
// bytes (K-way sum) moved per element. The design therefore only has to
// stream memory well: one CTA of 256 threads per 4096-element block, each
// thread moving 16 elements as four 16-byte float4 accesses (four char4 for
// the int8 side), neighbouring threads on neighbouring addresses. The per-block absmax of quantize is a
// warp-shuffle max followed by one shared-memory step across the 8 warps, so
// a block is read from device memory exactly once and kept in registers.
// The K-way sum keeps its 16 running sums per thread in registers across the
// loop over the K pods, reads each pod's codes once, and writes the output
// once (the TPU kernel's one-shot einsum over a (K, 8, 4096) tile becomes a
// loop inside the CTA); the K scales of a block are formed once, into
// shared memory.
//
// Numerics are pinned to the reference's live arithmetic: correctly rounded
// division and products (__fdiv_rn / __fmul_rn), rintf (half to even), an
// explicit fmaf for the fold, subnormals flushed to zero (common.cuh), and a
// zero element of a block whose scale overflows (0 * inf = NaN) encoded as 0.
// The absmax keeps NaN (an unsigned max of abs_bits): a block holding NaN has
// absmax NaN and all codes 0 (scale 0), one holding +-inf absmax inf, as in
// the reference.
// The build uses -fmad=false so nothing else is contracted. Do not build with
// --use_fast_math.
//
// Plain C interface (loaded with ctypes): every function takes raw device
// pointers and a cudaStream_t, launches on that stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 4096;                    // elements per quant block
constexpr int kThreads = 256;                   // threads per CTA
constexpr int kVecs = kBlock / (4 * kThreads);  // 4 float4 per thread
constexpr float kInv127 = 0x1.020408p-7f;       // f32(1/127)

__device__ __forceinline__ signed char code_of(float x, float scale) {
  const float r = rintf(__fmul_rn(x, scale));
  // fmaxf / fminf would turn NaN into -127; the reference encodes it as 0
  return r != r ? 0 : static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ unsigned abs_max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                float* __restrict__ absmax) {
  const long long b = blockIdx.x;
  const float4* xb = x + b * (kBlock / 4);
  char4* qb = q + b * (kBlock / 4);

  float4 v[kVecs];
  unsigned m = 0;   // the bits of max |x| (abs_bits: NaN wins)
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k] = ftz4(xb[threadIdx.x + k * kThreads]);
    m = max(m, abs_max4(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  unsigned am_bits = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) am_bits = max(am_bits, warp_max[w]);
  const float am = __uint_as_float(am_bits);

  const float scale = am > 0.f ? __fdiv_rn(127.f, am) : 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    char4 c;
    c.x = code_of(v[k].x, scale);
    c.y = code_of(v[k].y, scale);
    c.z = code_of(v[k].z, scale);
    c.w = code_of(v[k].w, scale);
    qb[threadIdx.x + k * kThreads] = c;
  }
  if (threadIdx.x == 0) absmax[b] = am;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const char4* __restrict__ q, const float* __restrict__ absmax,
                  float4* __restrict__ out) {
  const long long b = blockIdx.x;
  const char4* qb = q + b * (kBlock / 4);
  float4* ob = out + b * (kBlock / 4);
  const float s = ftz(__fmul_rn(ftz(absmax[b]), kInv127));
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const char4 c = qb[threadIdx.x + k * kThreads];
    float4 o;
    o.x = ftz(__fmul_rn(static_cast<float>(c.x), s));
    o.y = ftz(__fmul_rn(static_cast<float>(c.y), s));
    o.z = ftz(__fmul_rn(static_cast<float>(c.z), s));
    o.w = ftz(__fmul_rn(static_cast<float>(c.w), s));
    ob[threadIdx.x + k * kThreads] = o;
  }
}

// The fold's scale of one block, as XLA compiles the reference's
// (absmax / 127.0) * w: the division is a product with f32(1/127), and for
// two blocks or more the scalar constant is reassociated with the scalar
// weight, absmax * (f32(1/127) * w); at one block the constant is a
// one-element array and the product stays (absmax * f32(1/127)) * w.
__device__ __forceinline__ float fold_scale(float absmax, float w, bool one_block) {
  return one_block ? ftz(__fmul_rn(ftz(__fmul_rn(ftz(absmax), kInv127)), ftz(w)))
                   : ftz(__fmul_rn(ftz(absmax), ftz(__fmul_rn(kInv127, w))));
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(float4* __restrict__ acc, const char4* __restrict__ q,
            const float* __restrict__ absmax, float w, bool one_block) {
  const long long b = blockIdx.x;
  float4* ab = acc + b * (kBlock / 4);
  const char4* qb = q + b * (kBlock / 4);
  const float s = fold_scale(absmax[b], w, one_block);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const char4 c = qb[i];
    float4 a = ftz4(ab[i]);
    a.x = ftz(fmaf(static_cast<float>(c.x), s, a.x));
    a.y = ftz(fmaf(static_cast<float>(c.y), s, a.y));
    a.z = ftz(fmaf(static_cast<float>(c.z), s, a.z));
    a.w = ftz(fmaf(static_cast<float>(c.w), s, a.w));
    ab[i] = a;
  }
}

// Sum over k = 0 .. K-1 of w[k] * dequant(q[k]), in order, from 0: the
// fold's arithmetic (fold_scale, one fmaf per pod)
// with the running sum in registers. qs: (K, nblocks, 4096) int8;
// absmax: (K, nblocks); w: (K,); dynamic shared memory: K floats.
__global__ void __launch_bounds__(kThreads)
agg_kernel(const char4* __restrict__ qs, const float* __restrict__ absmax,
           const float* __restrict__ w, float4* __restrict__ out, int K,
           long long nblocks) {
  extern __shared__ float scale[];
  const long long b = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    scale[k] = fold_scale(absmax[k * nblocks + b], w[k], nblocks == 1);
  }
  __syncthreads();
  float4 acc[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < K; ++k) {
    const char4* qb = qs + (k * nblocks + b) * (kBlock / 4);
    const float s = scale[k];
    char4 c[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) c[j] = qb[threadIdx.x + j * kThreads];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      acc[j].x = ftz(fmaf(static_cast<float>(c[j].x), s, acc[j].x));
      acc[j].y = ftz(fmaf(static_cast<float>(c[j].y), s, acc[j].y));
      acc[j].z = ftz(fmaf(static_cast<float>(c[j].z), s, acc[j].z));
      acc[j].w = ftz(fmaf(static_cast<float>(c[j].w), s, acc[j].w));
    }
  }
  float4* ob = out + b * (kBlock / 4);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) ob[threadIdx.x + j * kThreads] = acc[j];
}

}  // namespace

extern "C" {

// x: (nblocks, 4096) f32 -> q: (nblocks, 4096) int8, absmax: (nblocks,) f32
int bw8_quantize(const void* x, void* q, void* absmax, long long nblocks,
                 void* stream) {
  if (nblocks > 0) {
    quantize_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<char4*>(q),
        static_cast<float*>(absmax));
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (nblocks, 4096) int8, absmax: (nblocks,) f32 -> out: (nblocks, 4096) f32
int bw8_dequantize(const void* q, const void* absmax, void* out,
                   long long nblocks, void* stream) {
  if (nblocks > 0) {
    dequantize_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char4*>(q), static_cast<const float*>(absmax),
        static_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: (nblocks, 4096) f32, updated in place; q int8; absmax f32; w scalar
int bw8_fold(void* acc, const void* q, const void* absmax, float w,
             long long nblocks, void* stream) {
  if (nblocks > 0) {
    fold_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<float4*>(acc), static_cast<const char4*>(q),
        static_cast<const float*>(absmax), w, nblocks == 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// qs: (K, nblocks, 4096) int8, absmax: (K, nblocks) f32, w: (K,) f32, all
// on the device -> out: (nblocks, 4096) f32, written (never read)
int bw8_agg(const void* qs, const void* absmax, const void* w, void* out,
            long long K, long long nblocks, void* stream) {
  if (nblocks > 0 && K > 0) {
    agg_kernel<<<static_cast<unsigned>(nblocks), kThreads,
                 static_cast<size_t>(K) * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char4*>(qs), static_cast<const float*>(absmax),
        static_cast<const float*>(w), static_cast<float4*>(out),
        static_cast<int>(K), nblocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
