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
//     feed the same kernel; `mode` (chosen by the wrapper from the strides and
//     alignment) picks how a tile is read: 1 = pixels of 12 contiguous
//     channels, 8-byte loads; 2 = channel planes with contiguous rows, 4-byte
//     loads; 0 = any strides, element by element
// w   the swizzled shared-memory image of both weights, one bulk copy
//     (ops/cuda_conv.py:_stem_kernel_weights): w1 as 2 K planes x 128 output
//     channels x 64 K values, K index (di*3 + dj)*12 + c, zero from 108; then
//     w2 as 8 slices (tap a*2 + b, t1 channel plane) x 64 output channels x
//     64 t1 channels
// bn  float [scale1, bias1 (128 each), scale2, bias2 (64 each)]
// out (N, H2, W2, 64) bf16 NHWC
//
// Bound on an H100 at the main path's shape (1, 512, 960): 45.8 GFLOP against
// 75 MB, the operations bind.  t1 (four times the output's size) never leaves
// shared memory.
//
// Design for Hopper (wgmma from shared memory, bulk copies, cp.async):
//   * a tile is 2 output rows x 64 columns; blocks are persistent, one per
//     SM, walk the tiles (image, row tile, column tile) in steps of the grid
//     and load both weights (96 KB) and the BN vectors once, by bulk copy;
//   * conv1 runs over the 3 x 65 t1 halo (rows y0-1 .. y0+1, columns
//     x0-1 .. x0+63) as a flat list in four m64 tiles (the last starts at row
//     131), two per warpgroup, N = 128, K = 108 packed into seven 16-deep
//     steps through an im2col tile: row = t1 pixel, K byte 24*tap + 2*c, so a
//     tap's 12 channels are three 8-byte moves from the x tile; lane u of a
//     warp always moves unit u (27 units a row), and the zero K tail (bytes
//     216 .. 255) is written once per block;
//   * t1 stays in shared memory, swizzled, in two 64-channel planes; conv1's
//     epilogue writes zeros for every t1 pixel outside the image (conv2' pads
//     t1, not x: conv1 over a zero border would give leaky(bias1) != 0), by a
//     mask, not a branch;
//   * conv2' reads t1 as runs of 64 consecutive rows shifted by
//     (r + a)*65 + b for output row r (one per warpgroup) and tap (a, b):
//     N = 64, 32 steps;
//   * the x tile is double-buffered: for contiguous input (mode 1) the next
//     tile's copies (cp.async, zero fill) are issued as a tile starts; while
//     conv2' runs the threads build the next im2col (loading the next x tile
//     first in the other modes);
//   * epilogues stay in registers (BN + leaky, a quad transpose by XOR
//     shuffles, 16-byte stores) and read the BN vectors from shared memory.
// What the first version of this design measured (chip_smoke.py phase
// counters): read from global at each use, the BN vectors' round trips were a
// third of a tile, and the epilogues' runtime-indexed selects and
// conditional stores compiled to branches around every element.
// Shared memory (bytes): w1 32,768 + w2 65,536 + im2col 4 x 16,384 + t1
// 25,600 + 24,960 + x tiles 2 x 8,048 + BN 1,536 + an mbarrier 8 = 232,040 of
// the 232,448 a block may use.

#include "hopper_common.cuh"

using namespace fconv;

namespace {

constexpr int kThreads = 256;            // two warpgroups: output rows y0, y0 + 1
constexpr int CIN = 12, C1 = 128, C2 = 64;
constexpr int kTH = 2, kTW = 64;         // output tile
constexpr int kT1W = kTW + 1;            // t1 halo columns x0-1 .. x0+63
constexpr int kT1Pix = (kTH + 1) * kT1W;  // 195
constexpr int kMT = 4;                   // m64 tiles of conv1
constexpr int kXR = kTH + 3, kXC = kTW + 3;  // x tile rows y0-2 .., columns x0-2 ..
constexpr int kXPix = kXR * kXC;         // 335
constexpr int kK1Steps = 7;              // K = 108 in 16-deep steps
// shared memory
constexpr int kW1 = 0;                        // 2 K planes x 128 rows x 128 B
constexpr int kW2 = kW1 + 2 * C1 * 128;       // 8 slices x 64 rows x 128 B
constexpr int kWBytes = 2 * C1 * 128 + 8 * C2 * 128;  // 98,304: one bulk copy
constexpr int kIM = kW1 + kWBytes;            // im2col: (m-tile, K plane) x 64 rows x 128 B
constexpr int kT1 = kIM + kMT * 2 * 8192;     // t1: plane 0, then plane 1 at + kT1Plane
constexpr int kT1Plane = 25600;               // 195 rows x 128 B, to a multiple of 1024
constexpr int kXBytes = (kXPix * CIN * 2 + 15) / 16 * 16;  // 8,048: an x tile, unswizzled
constexpr int kX = kT1 + kT1Plane + kT1Pix * 128;  // two x tiles (this one, the next)
constexpr int kBN = kX + 2 * kXBytes;         // BN vectors, 2 * (128 + 64) floats
constexpr int kBNBytes = 2 * (C1 + C2) * 4;
constexpr int kBar = kBN + kBNBytes;
constexpr int kSmem = kBar + 8;               // 232,040
static_assert(kSmem <= 232448, "shared memory");
static_assert(kT1Pix * 128 <= kT1Plane, "t1 plane");

// first t1 halo pixel of conv1's m64 tile mt; the last overlaps the one before
__device__ __forceinline__ int m_start(int mt) { return min(64 * mt, kT1Pix - 64); }

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const bf16* __restrict__ x, long long sn, long long sh, long long sw, long long sc,
            int mode, const bf16* __restrict__ w, const float* __restrict__ bn,
            bf16* __restrict__ out, int H2, int W2, int tiles_x, long long tiles_per_img,
            long long tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const float* s1 = reinterpret_cast<const float*>(smem + kBN);  // shared copies
  const float* b1 = s1 + C1;
  const float* s2 = s1 + 2 * C1;
  const float* b2 = s2 + C2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const long long my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (my_tiles <= 0) return;
  PHASE_START();

  auto tile_at = [&](long long it, int& n, int& y0, int& x0) {
    const long long t = blockIdx.x + it * gridDim.x;
    n = (int)(t / tiles_per_img);
    const int r = (int)(t - n * tiles_per_img);
    y0 = (r / tiles_x) * kTH;
    x0 = (r % tiles_x) * kTW;
  };
  // x tile `buf`, origin (y0-2, x0-2), zero outside the image (conv1's SAME
  // pad).  Mode 1 copies by cp.async (committed, waited before the im2col),
  // the others load through registers.
  auto load_x = [&](int n, int y0, int x0, int buf) {
    const bf16* ximg = x + n * sn;
    bf16* xt = reinterpret_cast<bf16*>(smem + kX + buf * kXBytes);
    if (mode == 1) {  // a pixel's 12 channels contiguous: three 8-byte copies
      for (int i = tid; i < kXPix * 3; i += kThreads) {
        const int px = i / 3, u = i - 3 * px;
        const int xr = px / kXC, xc = px - xr * kXC;
        const int gy = y0 - 2 + xr, gx = x0 - 2 + xc;
        const bool ok = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
        cp_async8(smem_addr(xt + px * CIN + 4 * u), ok ? ximg + gy * sh + gx * sw + 4 * u : x, ok);
      }
      cp_commit();
    } else if (mode == 2) {  // channel planes, rows contiguous: pairs of columns
      unsigned short* xs16 = reinterpret_cast<unsigned short*>(xt);
      constexpr int kPairs = (kXC + 1) / 2;  // 34
      for (int i = tid; i < kXR * CIN * kPairs; i += kThreads) {
        const int j = i % kPairs, rc = i / kPairs;
        const int c = rc % CIN, xr = rc / CIN;
        const int gy = y0 - 2 + xr, gx = x0 - 2 + 2 * j;  // even
        uint32_t v = 0u;
        if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
          const bf16* row = ximg + gy * sh + c * sc;
          if (gx + 1 < W2)
            v = __ldg(reinterpret_cast<const unsigned int*>(row + gx));
          else
            v = __ldg(reinterpret_cast<const unsigned short*>(row + gx));
        }
        xs16[(xr * kXC + 2 * j) * CIN + c] = (unsigned short)(v & 0xffffu);
        if (2 * j + 1 < kXC) xs16[(xr * kXC + 2 * j + 1) * CIN + c] = (unsigned short)(v >> 16);
      }
    } else {  // any strides
      const bf16 zero = __float2bfloat16(0.0f);
      for (int i = tid; i < kXPix * CIN; i += kThreads) {
        const int px = i / CIN, c = i - px * CIN;
        const int xr = px / kXC, xc = px - xr * kXC;
        const int gy = y0 - 2 + xr, gx = x0 - 2 + xc;
        bf16 v = zero;
        if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) v = ximg[gy * sh + gx * sw + c * sc];
        xt[i] = v;
      }
    }
  };
  // im2col from x tile `buf`: row = t1 halo pixel of an m-tile row, K byte
  // 8u = 24*tap + 8*part for u < 27.  Lane u of every warp moves unit u of
  // the rows warp, warp + 8, ...; the zeros from K byte 216 on are written
  // once, before the first tile (lanes 27..31).
  const int u = lane, tap = u / 3, part = u - 3 * (u / 3);
  const int di = tap / 3, dj = tap - 3 * (tap / 3);
  const uint32_t im_col = kIM + (u >> 4) * 8192;  // K plane of the unit
  auto build_im2col = [&](int buf) {
    if (u >= 27) return;
    const bf16* xt = reinterpret_cast<const bf16*>(smem + kX + buf * kXBytes) +
                     (di * kXC + dj) * CIN + 4 * part;
#pragma unroll 8
    for (int row = warp; row < kMT * 64; row += kThreads / 32) {
      const int mt = row >> 6, p = m_start(mt) + (row & 63);
      const int hr = p / kT1W, hc = p - hr * kT1W;
      const uint2 v = *reinterpret_cast<const uint2*>(xt + (hr * kXC + hc) * CIN);
      st_shared_v2(swz(base + im_col + mt * 2 * 8192 + (row & 63) * 128 + ((8 * u) & 127)), v);
    }
  };

  const uint32_t bar = base + kBar;
  if (tid == 0) {
    if (base & 1023) __trap();  // the swizzle needs 1024-byte aligned regions
    mbar_init(bar);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, kWBytes + kBNBytes);
    bulk_copy(base + kW1, w, kWBytes, bar);
    bulk_copy(base + kBN, bn, kBNBytes, bar);
  }
  if (u >= 27)  // the zero K tail of every im2col row, once
    for (int row = warp; row < kMT * 64; row += kThreads / 32)
      st_shared_v2(swz(base + im_col + (row >> 6) * 2 * 8192 + (row & 63) * 128 + ((8 * u) & 127)),
                   make_uint2(0u, 0u));
  int n, y0, x0;
  tile_at(0, n, y0, x0);
  load_x(n, y0, x0, 0);
  cp_wait<0>();
  __syncthreads();
  build_im2col(0);
  fence_proxy_async();
  __syncthreads();
  mbar_wait(bar, 0);

  for (long long it = 0; it < my_tiles; ++it) {
    const int nbuf = (int)((it + 1) & 1);  // the next tile's x buffer
    int nn = n, ny0 = y0, nx0 = x0;
    const bool more = it + 1 < my_tiles;
    if (more) tile_at(it + 1, nn, ny0, nx0);
    if (more && mode == 1) load_x(nn, ny0, nx0, nbuf);  // lands while this tile runs

    // ---- conv1: warpgroup wg takes m-tiles 2wg, 2wg + 1
    float acc[2][C1 / 2];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a0 = base + kIM + (2 * wg + i) * 2 * 8192;
#pragma unroll
      for (int kk = 0; kk < kK1Steps; ++kk)
        wgmma<C1>(acc[i], smem_desc(a0 + (kk >> 2) * 8192 + (kk & 3) * 32),
                  smem_desc(base + kW1 + (kk >> 2) * (C1 * 128) + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence<C1 / 2>(acc[0]);
    acc_fence<C1 / 2>(acc[1]);
    PHASE_MARK(0);
    // t1 = bf16(leaky(bn1(.))), exactly zero outside the image.  Row p of m-tile
    // mt is m_start(mt) + 16*w4 + g + 8*half, so p & 7 = (m_start(mt) + g) & 7
    {
      uint32_t row[2][2], keep[2][2], sw7[2];  // keep: all ones inside the image
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sw7[i] = (uint32_t)((m_start(2 * wg + i) + g) & 7);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = m_start(2 * wg + i) + 16 * w4 + g + 8 * half;
          const int gy = y0 - 1 + p / kT1W, gx = x0 - 1 + p % kT1W;
          row[i][half] = base + kT1 + p * 128 + 4 * q;
          keep[i][half] = gy >= 0 && gy < H2 && gx >= 0 && gx < W2 ? 0xffffffffu : 0u;
        }
      }
#pragma unroll
      for (int t = 0; t < C1 / 8; ++t) {
        const int ch = 8 * t + 2 * q;
        const float2 sv = *reinterpret_cast<const float2*>(s1 + ch);
        const float2 bv = *reinterpret_cast<const float2*>(b1 + ch);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t col = (ch >> 6) * kT1Plane + ((((ch & 63) >> 3) ^ sw7[i]) << 4);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* a = acc[i] + 4 * t + 2 * half;
            st_shared_u32(row[i][half] + col,
                          pack2(bn_leaky(a[0], sv.x, bv.x), bn_leaky(a[1], sv.y, bv.y)) &
                              keep[i][half]);
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // t1 complete; the x tile and im2col are free
    PHASE_MARK(1);

    // ---- conv2': warpgroup wg computes output row y0 + wg
    float acc2[C2 / 2];
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 4; ++tap)
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const int a = tap >> 1, b = tap & 1;
        const uint32_t a0 = base + kT1 + pl * kT1Plane + ((wg + a) * kT1W + b) * 128;
        const uint32_t b0 = base + kW2 + (tap * 2 + pl) * (C2 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<C2>(acc2, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32),
                    tap > 0 || pl > 0 || kk > 0);
      }
    wgmma_commit();
    PHASE_MARK(2);

    // the next tile's im2col (and x tile, where not copied ahead) while conv2' runs
    if (more) {
      if (mode == 1)
        cp_wait<0>();
      else
        load_x(nn, ny0, nx0, nbuf);
      __syncthreads();
      PHASE_MARK(3);
      build_im2col(nbuf);
      fence_proxy_async();
      PHASE_MARK(4);
    }
    wgmma_wait<0>();
    acc_fence<C2 / 2>(acc2);
    PHASE_MARK(5);

    // ---- epilogue: lane holds, after the transpose, eight consecutive
    // channels of pixel x0 + 16*w4 + g (+ 8)
    const int gy = y0 + wg;
#pragma unroll
    for (int grp = 0; grp < C2 / 32; ++grp) {
      float sc2[4][2], bi2[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 sv = *reinterpret_cast<const float2*>(s2 + grp * 32 + 8 * t + 2 * q);
        const float2 bv = *reinterpret_cast<const float2*>(b2 + grp * 32 + 8 * t + 2 * q);
        sc2[t][0] = sv.x, sc2[t][1] = sv.y, bi2[t][0] = bv.x, bi2[t][1] = bv.y;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t mine[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* a = acc2 + (grp * 4 + t) * 4 + 2 * half;
          mine[t] = pack2(bn_leaky(a[0], sc2[t][0], bi2[t][0]),
                          bn_leaky(a[1], sc2[t][1], bi2[t][1]));
        }
        quad_transpose(mine, lane);
        const int gx = x0 + 16 * w4 + g + 8 * half;
        if (gy < H2 && gx < W2)
          *reinterpret_cast<uint4*>(out + (((size_t)n * H2 + gy) * W2 + gx) * C2 + grp * 32 +
                                    8 * q) = make_uint4(mine[0], mine[1], mine[2], mine[3]);
      }
    }
    __syncthreads();  // the next im2col is complete; t1 is free
    PHASE_MARK(6);
    n = nn, y0 = ny0, x0 = nx0;
  }
  PHASE_FLUSH();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  Strides are in
// elements.
extern "C" int fused_stem_launch(const void* x, long long sn, long long sh, long long sw,
                                 long long sc, const void* w, const float* bn, void* out, int N,
                                 int H2, int W2, int mode, void* stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = request_smem(stem_kernel, kSmem, done);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W2 + kTW - 1) / kTW;
  const long long per_img = (long long)((H2 + kTH - 1) / kTH) * tiles_x;
  stem_kernel<<<persistent_blocks(per_img * N, 1), kThreads, kSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, sn, sh, sw, sc, mode, (const bf16*)w, bn, (bf16*)out, H2, W2, tiles_x,
      per_img, per_img * N);
  return (int)cudaGetLastError();
}
