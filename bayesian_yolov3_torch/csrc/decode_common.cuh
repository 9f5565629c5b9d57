// Device helpers shared by the decode kernels (epistemic_decode.cu,
// box_decode.cu).  Compile WITHOUT --use_fast_math: expf/logf and the
// division keep their IEEE semantics, which the saturated-probability
// entropies rely on.
#pragma once

#include <math.h>

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.0f ? p * logf(p) : 0.0f;  // exactly 0 at p <= 0
}

__device__ __forceinline__ float logistic_entropy(float p) {
  return -(xlogx(p) + xlogx(1.0f - p));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}
