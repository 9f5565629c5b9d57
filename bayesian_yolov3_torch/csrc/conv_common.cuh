// Shared pieces of the three fused early-backbone convolution kernels
// (fused_stem.cu, fused_res_block.cu, fused_downsample.cu).
//
// All three are implicit GEMMs on the tensor cores: M = output pixels of a
// tile, N = output channels, K = taps x input channels.  Activations are NHWC
// bf16, so a pixel's channels are contiguous and a run of pixels along W has a
// constant stride: a 16x16 A fragment (16 pixels x 16 channels) is loaded
// straight from the halo tile in shared memory with ldm = channel pitch, no
// im2col.  Weights are (cout, K) with K contiguous, i.e. a col-major B, and
// are read from global memory: they are at most 590 KB and stay in L2.
// Products are nvcuda::wmma 16x16x16 bf16 with float accumulators; each
// accumulator tile goes through a per-warp float staging tile so that the
// epilogue (BN affine, LeakyReLU, rounding) knows which (pixel, channel) it
// holds.
//
// wmma loads need 32-byte aligned pointers: every channel pitch below is a
// multiple of 16 elements (channels + kPitchPad).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fconv {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPitchPad = 16;   // elements added to a channel pitch
constexpr int kStageFloats = 256;  // one 16x16 float tile per warp

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// In the epilogue of a 16x16 tile a lane owns pixel `lane >> 1` and the
// eight channels starting at `(lane & 1) * 8`: one 16-byte store.
__device__ __forceinline__ int lane_pixel(int lane) { return lane >> 1; }
__device__ __forceinline__ int lane_chan(int lane) { return (lane & 1) * 8; }

// acc -> staging tile -> v[8] = bn_leaky of this lane's eight values.
__device__ __forceinline__ void stage_bn_leaky(const FragC& acc, float* stage,
                                               int lane, const float* scale,
                                               const float* bias, int ch,
                                               float* v) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const float* s = stage + lane_pixel(lane) * 16 + lane_chan(lane);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = bn_leaky(s[e], scale[ch + e], bias[ch + e]);
  __syncwarp();  // the tile is free for the next store
}

}  // namespace fconv
