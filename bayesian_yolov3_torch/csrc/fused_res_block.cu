// One darknet residual block in one pass:
//   t = bf16(leaky(bn_a(Wa . x)))            1x1, C -> C/2
//   y = bf16(leaky(bn_b(Wb * t)) + f32(x))   3x3 SAME over t, C/2 -> C, skip
//                                            added in float BEFORE the one rounding
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_conv.py:_res_kernel
// (behind fused_res_block_cf).  C = 64, 128, 256.
//
// x, out (N, H, W, C) bf16 NHWC;  wa (C/2, C) bf16;  wb (C, 9*C/2) bf16 with
// K index (di*3 + dj)*C/2 + c;  scale / bias vectors float.
//
// Bound on an H100: 10*C*C flops per pixel against 4*C bytes per pixel, i.e.
// 2.5*C flops per byte.  At C = 64 and 128 that is below the card's ~295
// flops per byte (bytes bind: 126 MB, 63 MB at the main path's shapes); at
// C = 256 the operations bind (20.1 GFLOP).  What the design does about it:
// the intermediate t never leaves shared memory, x is read once per tile
// (plus a one-pixel halo, 1.4x, mostly from L2) and feeds both the 1x1 and
// the skip, and the output is written once.
//
// The SAME padding pads t, not x: t must be EXACTLY zero outside the image.
// The 1x1 of a zero halo pixel would be leaky(bias_a) != 0, so the epilogue of
// the 1x1 writes zeros for every halo pixel outside the image (all four
// sides).  Ragged tiles are masked by bounds; no divisibility rule on H, W.

#include "conv_common.cuh"

using namespace fconv;

namespace {

constexpr int TH = 8;             // output rows of a tile
constexpr int TW = 16;            // output columns: one A fragment
constexpr int HH = TH + 2;        // halo tile
constexpr int HW = TW + 2;
constexpr int NPIX = HH * HW;     // 180 halo pixels
constexpr int MPIX = (NPIX + 15) / 16 * 16;  // 192: whole fragments

template <int C>
struct Cfg {
  static constexpr int CM = C / 2;
  static constexpr int XP = C + kPitchPad;   // channel pitch of the x tile
  static constexpr int TP = CM + kPitchPad;  // channel pitch of the t tile
  static constexpr size_t smem =
      (size_t)MPIX * XP * 2 + (size_t)MPIX * TP * 2 + kWarps * kStageFloats * 4;
};

__device__ __forceinline__ bool halo_inside(int p, int y0, int x0, int H, int W) {
  const int hr = p / HW, hc = p - hr * HW;
  const int gy = y0 - 1 + hr, gx = x0 - 1 + hc;
  return p < NPIX && gy >= 0 && gy < H && gx >= 0 && gx < W;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
res_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wa,
                 const bf16* __restrict__ wb, const float* __restrict__ sa,
                 const float* __restrict__ ba, const float* __restrict__ sb,
                 const float* __restrict__ bb, bf16* __restrict__ out, int H,
                 int W) {
  constexpr int CM = Cfg<C>::CM, XP = Cfg<C>::XP, TP = Cfg<C>::TP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (MPIX, XP)
  bf16* ts = xs + MPIX * XP;                     // (MPIX, TP)
  float* stage = reinterpret_cast<float*>(ts + MPIX * TP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t img = (size_t)blockIdx.z * H * W;  // first pixel of this image
  float* st = stage + warp * kStageFloats;

  // 1. the x halo tile, zero outside the image, 16 bytes per load
  constexpr int CH8 = C / 8;
  for (int i = tid; i < MPIX * CH8; i += kThreads) {
    const int p = i / CH8, q = i - p * CH8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (halo_inside(p, y0, x0, H, W)) {
      const int hr = p / HW, hc = p - hr * HW;
      const size_t pix = img + (size_t)(y0 - 1 + hr) * W + (x0 - 1 + hc);
      v = __ldg(reinterpret_cast<const uint4*>(x + pix * C) + q);
    }
    *reinterpret_cast<uint4*>(xs + p * XP + q * 8) = v;
  }
  __syncthreads();

  // 2. t over the halo: (MPIX x C) . (C x CM); a 1x1 conv, so the halo
  // pixels are just a list and fragments may straddle tile rows
  constexpr int NFM = CM / 16;
  for (int task = warp; task < (MPIX / 16) * NFM; task += kWarps) {
    const int mi = task / NFM, ni = task - mi * NFM;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < C; k += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, xs + mi * 16 * XP + k, XP);
      wmma::load_matrix_sync(b, wa + (size_t)ni * 16 * C + k, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    const int ch = ni * 16 + lane_chan(lane);
    float v[8];
    stage_bn_leaky(acc, st, lane, sa, ba, ch, v);
    const int p = mi * 16 + lane_pixel(lane);
    const uint4 packed = halo_inside(p, y0, x0, H, W) ? pack8(v)
                                                      : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(ts + p * TP + ch) = packed;
  }
  __syncthreads();

  // 3. the 3x3 over t: warps as 2 (row groups of 4) x 4 (channel groups);
  // a warp holds 4 rows x NP channel fragments of accumulators at a time
  constexpr int NFW = C / 16 / 4;          // channel fragments per warp: 1, 2, 4
  constexpr int NP = NFW < 2 ? NFW : 2;    // of which per pass
  constexpr int KB = 9 * CM;               // K of wb
  const int wm = warp >> 2, wn = warp & 3;
  for (int pass = 0; pass < NFW / NP; ++pass) {
    const int n_first = (wn * NFW + pass * NP) * 16;
    FragC acc[4][NP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap - di * 3;
      for (int k = 0; k < CM; k += 16) {
        FragB b[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          wmma::load_matrix_sync(
              b[j], wb + (size_t)(n_first + j * 16) * KB + tap * CM + k, KB);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wm * 4 + i;
          FragA a;
          wmma::load_matrix_sync(a, ts + ((row + di) * HW + dj) * TP + k, TP);
#pragma unroll
          for (int j = 0; j < NP; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
    // epilogue: BN, leaky, + x in float, one rounding, one 16-byte store
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 4 + i;
      const int col = lane_pixel(lane);
      const int gy = y0 + row, gx = x0 + col;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int ch = n_first + j * 16 + lane_chan(lane);
        float v[8], skip[8];
        stage_bn_leaky(acc[i][j], st, lane, sb, bb, ch, v);
        if (gy < H && gx < W) {
          unpack8(*reinterpret_cast<const uint4*>(
                      xs + ((row + 1) * HW + col + 1) * XP + ch), skip);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], skip[e]);
          const size_t pix = img + (size_t)gy * W + gx;
          *reinterpret_cast<uint4*>(out + pix * C + ch) = pack8(v);
        }
      }
    }
  }
}

template <int C>
int launch(const void* x, const void* wa, const void* wb, const float* sa,
           const float* ba, const float* sb, const float* bb, void* out, int N,
           int H, int W, cudaStream_t stream) {
  // above 48 KB the dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      res_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg<C>::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  res_block_kernel<C><<<grid, kThreads, Cfg<C>::smem, stream>>>(
      (const bf16*)x, (const bf16*)wa, (const bf16*)wb, sa, ba, sb, bb,
      (bf16*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success); -1 for a channel count
// the kernel is not built for.  The caller keeps N <= 65535 (grid z).
extern "C" int fused_res_block_launch(const void* x, const void* wa,
                                      const void* wb, const float* sa,
                                      const float* ba, const float* sb,
                                      const float* bb, void* out, int N, int H,
                                      int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch<64>(x, wa, wb, sa, ba, sb, bb, out, N, H, W, st);
    case 128: return launch<128>(x, wa, wb, sa, ba, sb, bb, out, N, H, W, st);
    case 256: return launch<256>(x, wa, wb, sa, ba, sb, bb, out, N, H, W, st);
    default: return -1;
  }
}
