// The stem, conv_00 + conv_01, in the 2x2 space-to-depth domain, one pass:
//   t1 = bf16(leaky(bn1(W1 * x)))     3x3 SAME, 12 -> 128 on the (H/2, W/2) grid
//   y  = bf16(leaky(bn2(W2 *' t1)))   2x2 with FRONT padding (1,0)x(1,0), 128 -> 64:
//                                     taps (a, b) in {0,1}^2 read t1[r-1+a, j-1+b]
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_conv.py:_stem_kernel
// (behind fused_stem_cf).
//
// x   the space-to-depth image, logical shape (N, H2, W2, 12) bf16, channel
//     (pi*2 + pj)*3 + c, addressed through four element strides so that both a
//     contiguous NHWC tensor and a view into host-packed channels-first planes
//     feed the same kernel
// w1  (128, 112) bf16, K index (di*3 + dj)*12 + c, columns 108..111 zero
// w2  (64, 512) bf16, K index (a*2 + b)*128 + c
// out (N, H2, W2, 64) bf16 NHWC
//
// Bound on an H100 at the main path's shape (1, 512, 960): 45.8 GFLOP against
// 75 MB, the operations bind.  What the design does about it: t1 (four times
// the output's size) never leaves shared memory, and conv1's K = 108 is packed
// into seven 16-deep steps through an im2col tile in shared memory instead of
// nine steps of which each would be a quarter empty.
//
// conv2' pads t1, not x: t1 at row -1 and at column -1 must be EXACTLY zero
// (conv1 over a zero border would give leaky(bias1) != 0), so conv1's
// epilogue writes zeros for every t1 pixel outside the image.

#include "conv_common.cuh"

using namespace fconv;

namespace {

constexpr int CIN = 12, C1 = 128, C2 = 64;
constexpr int TH = 8, TW = 16;        // output tile
constexpr int T1H = TH + 1, T1W = TW + 1;   // t1 tile: rows r-1..r, cols j-1..j
constexpr int T1PIX = T1H * T1W;      // 153
constexpr int MP = (T1PIX + 15) / 16 * 16;  // 160
constexpr int XH = TH + 3, XW = TW + 3;     // x tile: t1 tile plus one pixel around
constexpr int XPIX = XH * XW;         // 209
constexpr int XT_ELEMS = (XPIX * CIN + 15) / 16 * 16;
constexpr int K1 = 112;               // 9*12 = 108 padded to whole 16-steps
constexpr int KP = K1 + kPitchPad;    // pitch of the im2col tile
constexpr int TP = C1 + kPitchPad;    // channel pitch of the t1 tile
constexpr int K2 = 4 * C1;
constexpr size_t SMEM =
    (size_t)XT_ELEMS * 2 + (size_t)MP * KP * 2 + (size_t)MP * TP * 2 +
    kWarps * kStageFloats * 4;

static_assert(C1 / 16 == kWarps, "conv1: one warp per 16 output channels");
static_assert(TH == kWarps, "conv2': one warp per output row");

__global__ void __launch_bounds__(kThreads)
stem_kernel(const bf16* __restrict__ x, long long sn, long long sh, long long sw,
            long long sc, const bf16* __restrict__ w1, const bf16* __restrict__ w2,
            const float* __restrict__ s1, const float* __restrict__ b1,
            const float* __restrict__ s2, const float* __restrict__ b2,
            bf16* __restrict__ out, int H2, int W2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xt = reinterpret_cast<bf16*>(smem_raw);  // (XPIX, 12)
  bf16* patches = xt + XT_ELEMS;                 // (MP, KP)
  bf16* t1s = patches + MP * KP;                 // (MP, TP)
  float* stage = reinterpret_cast<float*>(t1s + MP * TP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const bf16* ximg = x + (long long)blockIdx.z * sn;
  float* st = stage + warp * kStageFloats;
  const bf16 zero = __float2bfloat16(0.0f);

  // 1. x tile, origin (y0-2, x0-2), zero outside the image (conv1's SAME pad)
  for (int i = tid; i < XPIX * CIN; i += kThreads) {
    const int p = i / CIN, c = i - p * CIN;
    const int xr = p / XW, xc = p - xr * XW;
    const int gy = y0 - 2 + xr, gx = x0 - 2 + xc;
    bf16 v = zero;
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2)
      v = ximg[(long long)gy * sh + (long long)gx * sw + (long long)c * sc];
    xt[i] = v;
  }
  __syncthreads();

  // 2. im2col: row p = t1 tile pixel (hr, hc), column (di*3+dj)*12 + c
  for (int i = tid; i < MP * KP; i += kThreads) {
    const int p = i / KP, k = i - p * KP;
    bf16 v = zero;
    if (p < T1PIX && k < 9 * CIN) {
      const int tap = k / CIN, c = k - tap * CIN;
      const int di = tap / 3, dj = tap - di * 3;
      const int hr = p / T1W, hc = p - hr * T1W;
      v = xt[((hr + di) * XW + hc + dj) * CIN + c];
    }
    patches[i] = v;
  }
  __syncthreads();

  // 3. conv1: warp = 16 of the 128 channels, its seven B fragments kept in
  // registers over the ten pixel fragments
  {
    FragB b[K1 / 16];
#pragma unroll
    for (int k = 0; k < K1 / 16; ++k)
      wmma::load_matrix_sync(b[k], w1 + (size_t)warp * 16 * K1 + k * 16, K1);
    const int ch = warp * 16 + lane_chan(lane);
    for (int mi = 0; mi < MP / 16; ++mi) {
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int k = 0; k < K1 / 16; ++k) {
        FragA a;
        wmma::load_matrix_sync(a, patches + mi * 16 * KP + k * 16, KP);
        wmma::mma_sync(acc, a, b[k], acc);
      }
      float v[8];
      stage_bn_leaky(acc, st, lane, s1, b1, ch, v);
      const int p = mi * 16 + lane_pixel(lane);
      const int hr = p / T1W, hc = p - hr * T1W;
      const int gy = y0 - 1 + hr, gx = x0 - 1 + hc;
      const bool inside = p < T1PIX && gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
      *reinterpret_cast<uint4*>(t1s + p * TP + ch) =
          inside ? pack8(v) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  // 4. conv2': warp = output row, four channel fragments
  {
    const int row = warp;
    FragC acc[C2 / 16];
#pragma unroll
    for (int j = 0; j < C2 / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int tap = 0; tap < 4; ++tap) {
      const int a_ = tap >> 1, b_ = tap & 1;
      for (int k = 0; k < C1; k += 16) {
        FragA a;
        wmma::load_matrix_sync(a, t1s + ((row + a_) * T1W + b_) * TP + k, TP);
#pragma unroll
        for (int j = 0; j < C2 / 16; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, w2 + (size_t)j * 16 * K2 + tap * C1 + k, K2);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    const int gy = y0 + row, gx = x0 + lane_pixel(lane);
    const size_t pix = ((size_t)blockIdx.z * H2 + gy) * W2 + gx;
#pragma unroll
    for (int j = 0; j < C2 / 16; ++j) {
      const int ch = j * 16 + lane_chan(lane);
      float v[8];
      stage_bn_leaky(acc[j], st, lane, s2, b2, ch, v);
      if (gy < H2 && gx < W2)
        *reinterpret_cast<uint4*>(out + pix * C2 + ch) = pack8(v);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  Strides are in
// elements.  The caller keeps N <= 65535 (grid z).
extern "C" int fused_stem_launch(const void* x, long long sn, long long sh,
                                 long long sw, long long sc, const void* w1,
                                 const void* w2, const float* s1, const float* b1,
                                 const float* s2, const float* b2, void* out,
                                 int N, int H2, int W2, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, N);
  stem_kernel<<<grid, kThreads, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, sn, sh, sw, sc, (const bf16*)w1, (const bf16*)w2, s1, b1,
      s2, b2, (bf16*)out, H2, W2);
  return (int)cudaGetLastError();
}
