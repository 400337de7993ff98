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
