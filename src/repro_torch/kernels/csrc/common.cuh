// Helpers shared by the kernel sources in this directory.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

// Flush a float32 subnormal to zero, keeping its sign. The reference's
// arithmetic runs with subnormals flushed (XLA's CPU build sets the x86
// FTZ and DAZ modes; a TPU flushes them too), while the card keeps them
// unless told otherwise: the kernels flush explicitly, on the inputs and
// the results of each float step whose subnormals could reach the output,
// so the build flags need not change.
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.f, x) : x;
}

__device__ __forceinline__ float4 ftz4(float4 v) {
  return make_float4(ftz(v.x), ftz(v.y), ftz(v.z), ftz(v.w));
}

// |x| as its bit pattern. For floats with the sign bit clear, the order of
// the bits as unsigned integers is the order of the values, and every NaN lies
// above +inf; so an unsigned max over these keeps NaN, where fmaxf returns the
// other operand. The reference's absmax (a reduce-max in XLA) gives NaN for a
// block holding one, and the kernels' absmax reductions are unsigned maxes of
// abs_bits, one instruction each.
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}
