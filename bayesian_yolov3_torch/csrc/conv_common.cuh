// Arithmetic shared by the three fused early-backbone convolution kernels
// (fused_stem.cu, fused_res_block.cu, fused_downsample.cu): the BN affine and
// LeakyReLU with the plain version's roundings, and bf16 packing.  Each
// kernel is an implicit GEMM on the tensor cores (M = output pixels of a
// tile, N = output channels, K = taps x input channels) with bf16 operands
// and float accumulators; the Hopper pieces they are built from are in
// hopper_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fconv {

typedef __nv_bfloat16 bf16;

// BN affine + LeakyReLU(0.1) in float, with the roundings of the plain
// version (a multiply, an add, a multiply: no FMA contraction).
__device__ __forceinline__ float bn_leaky(float acc, float scale, float bias) {
  const float v = __fadd_rn(__fmul_rn(acc, scale), bias);
  return v >= 0.0f ? v : __fmul_rn(0.1f, v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(b);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

}  // namespace fconv
