// Blockwise-int8 kernels for Hopper (sm_90a): quantize, dequantize and the
// server's in-place streaming fold.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant_blockwise8.py  quantize_blockwise8_pallas   (_quantize_kernel)
//   src/repro/kernels/quant_blockwise8.py  dequantize_blockwise8_pallas (_dequantize_kernel)
//   src/repro/kernels/fused_dequant_agg.py dequant_accumulate8_into_pallas (_fold_kernel)
//
// All three are bound by device memory: a handful of float operations per
// element against 5 bytes (quantize, dequantize) or 9 bytes (fold) moved per
// element. The design therefore only has to stream memory well: one CTA of
// 256 threads per 4096-element block, each thread moving 16 elements as four
// 16-byte float4 accesses (four char4 for the int8 side), neighbouring
// threads on neighbouring addresses. The per-block absmax of quantize is a
// warp-shuffle max followed by one shared-memory step across the 8 warps, so
// a block is read from device memory exactly once and kept in registers.
//
// Numerics are pinned to the reference's live arithmetic: correctly rounded
// division and products (__fdiv_rn / __fmul_rn), rintf (half to even), an
// explicit fmaf for the fold, and the build uses -fmad=false so nothing else
// is contracted. Do not build with --use_fast_math.
//
// Plain C interface (loaded with ctypes): every function takes raw device
// pointers and a cudaStream_t, launches on that stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 4096;                    // elements per quant block
constexpr int kThreads = 256;                   // threads per CTA
constexpr int kVecs = kBlock / (4 * kThreads);  // 4 float4 per thread
constexpr float kInv127 = 0x1.020408p-7f;       // f32(1/127)

__device__ __forceinline__ signed char code_of(float x, float scale) {
  return static_cast<signed char>(
      fminf(fmaxf(rintf(__fmul_rn(x, scale)), -127.f), 127.f));
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                float* __restrict__ absmax) {
  const long long b = blockIdx.x;
  const float4* xb = x + b * (kBlock / 4);
  char4* qb = q + b * (kBlock / 4);

  float4 v[kVecs];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k] = xb[threadIdx.x + k * kThreads];
    m = fmaxf(m, abs_max4(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float am = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) am = fmaxf(am, warp_max[w]);

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
  const float s = __fmul_rn(absmax[b], kInv127);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const char4 c = qb[threadIdx.x + k * kThreads];
    float4 o;
    o.x = __fmul_rn(static_cast<float>(c.x), s);
    o.y = __fmul_rn(static_cast<float>(c.y), s);
    o.z = __fmul_rn(static_cast<float>(c.z), s);
    o.w = __fmul_rn(static_cast<float>(c.w), s);
    ob[threadIdx.x + k * kThreads] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(float4* __restrict__ acc, const char4* __restrict__ q,
            const float* __restrict__ absmax, float w) {
  const long long b = blockIdx.x;
  float4* ab = acc + b * (kBlock / 4);
  const char4* qb = q + b * (kBlock / 4);
  const float s = __fmul_rn(absmax[b], __fmul_rn(kInv127, w));
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const char4 c = qb[i];
    float4 a = ab[i];
    a.x = fmaf(static_cast<float>(c.x), s, a.x);
    a.y = fmaf(static_cast<float>(c.y), s, a.y);
    a.z = fmaf(static_cast<float>(c.z), s, a.z);
    a.w = fmaf(static_cast<float>(c.w), s, a.w);
    ab[i] = a;
  }
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
        static_cast<const float*>(absmax), w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
