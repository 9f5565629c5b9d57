// Stride-2 3x3 convolution with darknet (1,1)x(1,1) zero padding, BN affine,
// LeakyReLU, one rounding to bf16:  C -> 2C, C = 64, 128.
//   out[r, J] = sum over (di, dj, c) of w[o, di, dj, c] * x[2r-1+di, 2J-1+dj, c]
//
// Replaces the TPU kernels bayesian_yolov3_tpu/ops/pallas_conv.py:
// _down_packed_kernel (behind fused_downsample_packed_cf) and _down_kernel
// (behind fused_downsample_cf).  Those two differ only in how the TPU laid
// the input columns out (phase-packed rows / even and odd halves); this one
// kernel takes the plain NHWC tensor and splits the phases itself.
//
// x (N, H, W, C) bf16 NHWC;  w (9*C/64, 2C, 64) bf16: K slice s = cb*9 +
// di*3 + dj holds w[:, 64*cb .. 64*cb+63, di, dj] (ops/cuda_conv.py:
// _down_kernel_weights);  out (N, HO, WO, 2C) bf16, HO = (H-1)/2 + 1,
// WO = (W-1)/2 + 1.
//
// Bound on an H100: 36*C*C flops against 12*C bytes per output pixel.  At the
// main path's shapes the two launches move 142 MB and do 36 GFLOP: 0.047 ms.
// Design for Hopper (wgmma from shared memory, bulk copies, cp.async):
//   * a block is two warpgroups and computes 128 output pixels (2 rows x 64
//     columns) x 128 output channels: each warpgroup one output row, one
//     wgmma.m64n128k16 per 16 channels of K, so each block's weight reads
//     serve 128 pixels; two blocks fit an SM (113 KB of shared memory each),
//     so one block's loads overlap the other's products;
//   * the input halo tile (5 rows x 129 columns x 64 channels) is staged once
//     per 64-channel block with cp.async, split into its even and odd input
//     columns: the three column taps then read runs of 64 consecutive pixel
//     rows (dj = 1 the odd-t half, dj = 0 and dj = 2 the even-t half, shifted
//     by one), which is what a wgmma descriptor needs, as the TPU kernel's
//     xe_s / xo_s split was what its matmuls needed;
//   * the weights stream through a two-stage ring of 64-wide K slices, each
//     16 KB slice one bulk copy completing on an mbarrier (the cached weight
//     layout is the stage's swizzled image); the wgmma of a slice runs
//     asynchronously while the warps wait for the previous one and refill
//     the freed stage, and the input rows load as the taps before free them,
//     so after the first two rows and slice no load stands alone in a
//     block's timeline;
//   * every shared row is 128 bytes, its 16-byte chunks XOR-swizzled by
//     address bits 7-9: the 128-byte swizzle that wgmma's descriptors read
//     (it follows the address, so a run of rows may start mid-pattern), and
//     conflict-free for the cp.async stores;
//   * the epilogue stays in registers: BN + leaky on the accumulator layout,
//     a bf16 pair per register, a 4x4 shuffle transpose inside each quad of
//     lanes, then one 16-byte store of 8 consecutive channels per lane.
// Rows and columns outside the image are zero (cp.async zero fill), odd
// extents and ragged tiles are masked.
// What still holds it back (PERF.md): the products are about a quarter of its
// time on the card; timing a block's phases showed the first rows and slice,
// the epilogue and the row loads as the rest.  Tried and measured slower on
// the H100: persistent blocks that walk down columns and prefetch the next
// tile's rows (by cp.async or by tensor-map boxes), four-warpgroup tiles, an
// eight-stage ring of 32-channel slices, bulk-copy stores.

#include "hopper_common.cuh"

using namespace fconv;

namespace {

constexpr int kTH = 2;                    // output rows of a block tile: one per warpgroup
constexpr int kTW = 64;                   // output columns of a block tile: wgmma M
constexpr int kIH = 2 * kTH + 1;          // input rows of the halo tile
constexpr int kNE = kTW + 1;              // even-t input columns (t = 0, 2, .., 2*kTW)
constexpr int kRowPix = kNE + kTW;        // + odd-t columns (t = 1, 3, .., 2*kTW-1)
constexpr int kTilePix = kIH * kRowPix;   // 645 pixels
constexpr int kKC = 64;                   // input channels of a K slice: 128 bytes
constexpr int kBN = 128;                  // output channels of a block: wgmma N
constexpr int kDThreads = 128 * kTH;      // one warpgroup per output row: 256
constexpr int kWBytes = kBN * kKC * 2;    // 16,384 per ring stage
constexpr int kXOff = 2 * kWBytes;        // the halo tile after the two stages
constexpr int kBarOff = kXOff + kTilePix * kKC * 2;  // an mbarrier per stage
constexpr int kSmem = kBarOff + 2 * 8;               // 115,344: two blocks per SM

// Input row `ir` (0..kIH-1) of the halo tile, its 64 channels from cb*64:
// global row 2*y0-1+ir; pixel q of the row is local column t = 2q (q < kNE)
// or t = 2(q-kNE)+1, global column 2*x0-1+t.
template <int C>
__device__ __forceinline__ void load_row(uint32_t xs, const bf16* xin, int cb, int ir, int y0,
                                         int x0, int H, int W, int tid) {
  const int gy = 2 * y0 - 1 + ir;
  for (int i = tid; i < kRowPix * 8; i += kDThreads) {
    const int q = i >> 3, ch = i & 7;
    const int t = q < kNE ? 2 * q : 2 * (q - kNE) + 1;
    const int gx = 2 * x0 - 1 + t;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = ok ? xin + ((size_t)gy * W + gx) * C + cb * kKC + ch * 8 : xin;
    cp_async16(swz(xs + (ir * kRowPix + q) * 128 + ch * 16), src, ok);
  }
}

// Iteration i of the K loop works on channel block cb = i / 9, tap (di, dj).
// The taps of the second channel block run di = 1, 0, 2, so that its rows
// can load into the tile as the first block's taps free them (row r of the
// tile serves warpgroup wg at di = r - 2*wg).
__device__ __forceinline__ int tap_di(int i) {
  const int cb = i / 9, k = (i % 9) / 3;
  return cb == 0 ? k : (k == 0 ? 1 : k == 1 ? 0 : 2);
}

template <int C>
__global__ void __launch_bounds__(kDThreads, 2)
downsample_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int H, int W, int HO, int WO) {
  constexpr int CO = 2 * C, NCB = C / kKC, S = 9 * NCB, NB = CO / kBN;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ws = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t xs = ws + kXOff;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;        // warpgroup: output row y0 + wg
  const int nb = blockIdx.x % NB;  // which 128 of the output channels
  const int x0 = (blockIdx.x / NB) * kTW, y0 = blockIdx.y * kTH;
  const bf16* xin = x + (size_t)blockIdx.z * H * W * C;
  const bf16* wb = w + (size_t)nb * kBN * kKC;  // slice s at + s * CO * kKC

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // Weights: each 16 KB slice is one bulk copy (the cached layout is the
  // stage's swizzled image) completing on its stage's mbarrier.  Input rows:
  // cp.async, one group an iteration, issued as soon as the taps before free
  // them and waited two iterations later.  Each iteration: wait for its
  // slice and rows, issue its wgmma asynchronously, wait for the previous
  // wgmma, then refill the freed stage and load rows while this one runs.
  // (With 16-byte cp.async for the weights too, every thread spent part of
  // each iteration issuing requests; the bulk copy is one request.)
  const uint32_t bars = ws + kBarOff;
  auto slice_src = [&](int i) {
    return wb + (size_t)(i / 9 * 9 + tap_di(i) * 3 + i % 3) * CO * kKC;
  };
  if (tid == 0) {
    if (ws & 1023) __trap();  // the copied slices are swizzled for 1024-byte alignment
    mbar_init(bars);
    mbar_init(bars + 8);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) bulk_load(ws, slice_src(0), kWBytes, bars);
  for (int r = 0; r < 2 * kTH; r += 2) load_row<C>(xs, xin, 0, r, y0, x0, H, W, tid);
  cp_commit();
  cp_commit();  // empty: iteration 0 waits for all groups but the newest
  const uint32_t sbias = xs;  // BN scale and bias, in row 0 once the taps free it
  for (int i = 0; i < S; ++i) {
    const int di = tap_di(i), dj = i % 3;
    mbar_wait(bars + 8 * (i & 1), (i >> 1) & 1);
    cp_wait<1>();
    fence_proxy_async();  // rows visible to wgmma
    __syncthreads();  // iteration i's slice and rows have landed
    // A: 64 pixel rows from this tap's first pixel; B: the stage's 128 rows
    const int p0 = (2 * wg + di) * kRowPix + (dj == 1 ? kNE : (dj >> 1));
    const uint32_t a0 = xs + p0 * 128, b0 = ws + (i & 1) * kWBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)  // 16 channels = 32 bytes a step
      wgmma<kBN>(acc, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmma of iteration i-1 has retired
    acc_fence<64>(acc);
    __syncthreads();     // both warpgroups': its stage and rows are free
    if (tid == 0 && i + 1 < S)
      bulk_load(ws + ((i + 1) & 1) * kWBytes, slice_src(i + 1), kWBytes, bars + 8 * ((i + 1) & 1));
    // rows for later taps, (channel block, row), as the taps before free
    // them: odd rows serve di = 1, even rows di = 0 (row r, warpgroup r/2)
    // and di = 2 (warpgroup r/2 - 1)
    if (i == 0)
      for (int r = 1; r < 2 * kTH; r += 2) load_row<C>(xs, xin, 0, r, y0, x0, H, W, tid);
    if (i == 1) load_row<C>(xs, xin, 0, 2 * kTH, y0, x0, H, W, tid);
    if (NCB > 1 && i == 3) load_row<C>(xs, xin, 1, 0, y0, x0, H, W, tid);
    if (NCB > 1 && i == 6)
      for (int r = 1; r < 2 * kTH; r += 2) load_row<C>(xs, xin, 1, r, y0, x0, H, W, tid);
    if (NCB > 1 && i == 9)
      for (int r = 2; r <= 2 * kTH; r += 2) load_row<C>(xs, xin, 1, r, y0, x0, H, W, tid);
    if (i == S - 3 && tid < kBN / 2)  // the last three taps (di = 2) never read row 0
      cp_async16(sbias + tid * 16,
                 tid < kBN / 4 ? scale + nb * kBN + tid * 4
                               : bias + nb * kBN + (tid - kBN / 4) * 4,
                 true);
    cp_commit();
  }
  wgmma_wait<0>();
  acc_fence<64>(acc);
  // scale and bias (issued at S-3) were waited at the top of iteration S-1
  const float* sb_f = reinterpret_cast<const float*>(smem + kXOff);

  // epilogue: thread (warp w4 of its warpgroup, g = lane/4, q = lane%4) holds,
  // for each channel tile t of 8, channels 8t+2q, +1 of pixels 16*w4 + g, +8
  const int g = lane >> 2, q = lane & 3, w4 = warp & 3;
  const int gy = y0 + wg;
  bf16* out_img = out + (size_t)blockIdx.z * HO * WO * CO;
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {  // channel tiles 4*grp .. 4*grp+3
    float sc[4][2], bi[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 s2 = *reinterpret_cast<const float2*>(sb_f + grp * 32 + t * 8 + 2 * q);
      const float2 b2 = *reinterpret_cast<const float2*>(sb_f + kBN + grp * 32 + t * 8 + 2 * q);
      sc[t][0] = s2.x, sc[t][1] = s2.y, bi[t][0] = b2.x, bi[t][1] = b2.y;
    }
    const int chg = nb * kBN + grp * 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // pixel g, then g + 8
      uint32_t mine[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* a = acc + (grp * 4 + t) * 4 + 2 * half;
        mine[t] = pack2(bn_leaky(a[0], sc[t][0], bi[t][0]), bn_leaky(a[1], sc[t][1], bi[t][1]));
      }
      // lane q gathers channel tile 4*grp + q: channels 8q .. 8q+7 of the group
      quad_transpose(mine, lane);
      const uint4 v = make_uint4(mine[0], mine[1], mine[2], mine[3]);
      const int gx = x0 + 16 * w4 + g + half * 8;
      if (gy < HO && gx < WO)
        *reinterpret_cast<uint4*>(out_img + ((size_t)gy * WO + gx) * CO + chg + q * 8) = v;
    }
  }
}

template <int C>
int launch(const void* x, const void* w, const float* scale, const float* bias,
           void* out, int N, int H, int W, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = request_smem(downsample_kernel<C>, kSmem, done);
  if (err != cudaSuccess) return (int)err;
  const int HO = (H - 1) / 2 + 1, WO = (W - 1) / 2 + 1;
  dim3 grid(((WO + kTW - 1) / kTW) * (2 * C / kBN), (HO + kTH - 1) / kTH, N);
  downsample_kernel<C><<<grid, kDThreads, kSmem, stream>>>(
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
