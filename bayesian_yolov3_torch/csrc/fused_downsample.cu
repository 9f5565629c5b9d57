// Stride-2 3x3 convolution with darknet (1,1)x(1,1) zero padding, BN affine,
// LeakyReLU, one rounding to bf16:  C -> 2C, C = 64, 128.
//   out[r, J] = sum over (di, dj, c) of w[o, di, dj, c] * x[2r-1+di, 2J-1+dj, c]
//
// Replaces the TPU kernels bayesian_yolov3_tpu/ops/pallas_conv.py:
// _down_packed_kernel (behind fused_downsample_packed_cf) and _down_kernel
// (behind fused_downsample_cf).  Those two differ only in how the TPU laid
// the input columns out (phase-packed rows / even and odd halves); on NHWC
// the column stride of 2 is a fragment pitch of two pixels, so one kernel
// serves both.
//
// x (N, H, W, C) bf16 NHWC;  w (2C, 9*C) bf16, K index (di*3 + dj)*C + c;
// out (N, HO, WO, 2C) bf16, HO = (H-1)/2 + 1, WO = (W-1)/2 + 1.
//
// Bound on an H100: 36*C*C flops against 12*C bytes per output pixel, 3*C
// flops per byte.  At C = 64 the bytes bind (94 MB at the main path's shape),
// at C = 128 the operations (18.1 GFLOP against 47 MB).  What the design
// does about it: the input tile is read once into shared memory (the 9 taps
// reuse it there) and the output is written once.
//
// Rows and columns outside the image are zero (masked by bounds, so odd
// extents are right too); ragged output tiles are masked.

#include "conv_common.cuh"

using namespace fconv;

namespace {

constexpr int TH = 4;             // output rows of a tile
constexpr int TW = 16;            // output columns: one A fragment
constexpr int IH = 2 * TH + 1;    // input rows of a tile
constexpr int IW = 2 * TW + 1;
constexpr int NPIX = IH * IW;     // 297 input pixels

template <int C>
struct Cfg {
  static constexpr int XP = C + kPitchPad;
  static constexpr size_t smem = (size_t)NPIX * XP * 2 + kWarps * kStageFloats * 4;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int H, int W, int HO, int WO) {
  constexpr int XP = Cfg<C>::XP, CO = 2 * C, KB = 9 * C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (NPIX, XP)
  float* stage = reinterpret_cast<float*>(xs + NPIX * XP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;  // output coordinates
  const size_t img_in = (size_t)blockIdx.z * H * W;
  const size_t img_out = (size_t)blockIdx.z * HO * WO;
  float* st = stage + warp * kStageFloats;

  // the input tile: rows 2*y0-1 .., columns 2*x0-1 .., zero outside the image
  constexpr int CH8 = C / 8;
  for (int i = tid; i < NPIX * CH8; i += kThreads) {
    const int p = i / CH8, q = i - p * CH8;
    const int ir = p / IW, ic = p - ir * IW;
    const int gy = 2 * y0 - 1 + ir, gx = 2 * x0 - 1 + ic;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const uint4*>(x + (img_in + (size_t)gy * W + gx) * C) + q);
    *reinterpret_cast<uint4*>(xs + p * XP + q * 8) = v;
  }
  __syncthreads();

  // warps as 2 (row pairs) x 4 (channel groups): 2 x NFW accumulator tiles
  constexpr int NFW = CO / 16 / 4;  // 2, 4
  const int wm = warp >> 2, wn = warp & 3;
  const int n_first = wn * NFW * 16;
  FragC acc[2][NFW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NFW; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3, dj = tap - di * 3;
    for (int k = 0; k < C; k += 16) {
      FragB b[NFW];
#pragma unroll
      for (int j = 0; j < NFW; ++j)
        wmma::load_matrix_sync(
            b[j], w + (size_t)(n_first + j * 16) * KB + tap * C + k, KB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 2 + i;
        FragA a;  // 16 output columns read every second input pixel
        wmma::load_matrix_sync(a, xs + ((2 * row + di) * IW + dj) * XP + k, 2 * XP);
#pragma unroll
        for (int j = 0; j < NFW; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = y0 + wm * 2 + i, gx = x0 + lane_pixel(lane);
#pragma unroll
    for (int j = 0; j < NFW; ++j) {
      const int ch = n_first + j * 16 + lane_chan(lane);
      float v[8];
      stage_bn_leaky(acc[i][j], st, lane, scale, bias, ch, v);
      if (gy < HO && gx < WO)
        *reinterpret_cast<uint4*>(out + (img_out + (size_t)gy * WO + gx) * CO + ch) =
            pack8(v);
    }
  }
}

template <int C>
int launch(const void* x, const void* w, const float* scale, const float* bias,
           void* out, int N, int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      downsample_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg<C>::smem);
  if (err != cudaSuccess) return (int)err;
  const int HO = (H - 1) / 2 + 1, WO = (W - 1) / 2 + 1;
  dim3 grid((WO + TW - 1) / TW, (HO + TH - 1) / TH, N);
  downsample_kernel<C><<<grid, kThreads, Cfg<C>::smem, stream>>>(
      (const bf16*)x, (const bf16*)w, scale, bias, (bf16*)out, H, W, HO, WO);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success); -1 for an input channel
// count the kernel is not built for.  The caller keeps N <= 65535 (grid z).
extern "C" int fused_downsample_launch(const void* x, const void* w,
                                       const float* scale, const float* bias,
                                       void* out, int N, int H, int W, int C,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch<64>(x, w, scale, bias, out, N, H, W, st);
    case 128: return launch<128>(x, w, scale, bias, out, N, H, W, st);
    default: return -1;
  }
}
