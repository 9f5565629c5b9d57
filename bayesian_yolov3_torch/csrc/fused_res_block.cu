// One darknet residual block in one pass:
//   t = bf16(leaky(bn_a(Wa . x)))            1x1, C -> C/2
//   y = bf16(leaky(bn_b(Wb * t)) + f32(x))   3x3 SAME over t, C/2 -> C, skip
//                                            added in float BEFORE the one rounding
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_conv.py:_res_kernel
// (behind fused_res_block_cf).  C = 64, 128, 256.
//
// x, out (N, H, W, C) bf16 NHWC;  w the weight pieces of ops/cuda_conv.py:
// _res_kernel_weights, each the swizzled shared-memory image of one bulk
// copy: first C/64 pieces of wa (C/2 rows = t channels, 64 input channels),
// then for each block h of 128 output channels (one below C = 256) and each
// 64-wide K slice s of the 3x3 (K index (di*3 + dj)*C/2 + c, zero past
// 9*C/2) a piece of wb;  bn float [scale_a, bias_a (C/2 each), scale_b, bias_b (C each)].
//
// Bound on an H100: 10*C*C flops per pixel against 4*C bytes per pixel, i.e.
// 2.5*C flops per byte.  At C = 64 and 128 that is below the card's ~295
// flops per byte (bytes bind: 126 MB, 63 MB at (1, 512, 960) and
// (1, 256, 480)); at C = 256 the operations bind (20.1 GFLOP at
// (1, 128, 240)).  The intermediate t never leaves shared memory, x is read
// once per tile (plus its one-pixel halo, mostly from L2) and the output is
// written once.
//
// Design for Hopper (wgmma from shared memory, bulk and tensor-map copies):
//   * a tile is 2 output rows x 62 columns, so that its halo, 4 rows x 64
//     columns = 256 pixels, is four m64 tiles of the 1x1: a flat list of
//     128-byte rows (64 channels each).  Blocks are persistent, one per SM
//     (two at C = 64), and walk the tiles (image, row tile, column tile) in
//     steps of the grid, across image boundaries;
//   * the 1x1 runs over the halo list in its four m64 tiles, K sliced by 64
//     input channels; each warpgroup computes half of t's channels (wgmma
//     N = C/4) for all four (at C = 256 that is 128 accumulator registers: a
//     66-column halo needs a fifth m64 tile and spilled);
//   * t stays in shared memory, swizzled, its channels in 64-wide planes;
//     the epilogue of the 1x1 writes zeros for every halo pixel outside the
//     image (all four sides: the SAME padding pads t, not x, and the 1x1 of a
//     zero pixel would be leaky(bias_a) != 0);
//   * the 3x3 reads t as runs of 64 consecutive halo rows, shifted by
//     (r + di)*64 + dj for output row r and tap (di, dj): one warpgroup per
//     output row, N = C (at C = 256 two blocks of 128, one after the other,
//     so 64 accumulator registers, not 128, which spilled); rows 62 and 63 of a
//     run wrap into the next halo row (or the plane's 8 spare rows) and give
//     the two output columns that are not stored;
//   * the weights stream as pieces through a ring of bulk copies on
//     mbarriers, in the same order every tile, so the ring runs on across
//     tiles; where all pieces fit (C = 64) they load once per block;
//   * x streams through the 1x1 in 64-channel slices, two stages, each slice
//     one tensor-map copy (TMA: the 64 x 64 x 4 box lands 128-byte swizzled,
//     zeros outside the image) on an mbarrier; the next tile's first slices
//     load while this tile's 3x3 runs.  (Per-thread cp.async of the same
//     slices cost 15-19 % of a tile at C = 64 and 128 just to issue.)
//   * the epilogues stay in registers: BN + leaky on the accumulator layout
//     (the BN vectors in shared memory), t stored through an inside-the-image
//     mask; for y a quad transpose by XOR shuffles to eight consecutive
//     channels a lane, the skip (loaded before the 3x3's products) added in
//     float, one rounding, one 16-byte store.
// What the first version of this design measured (chip_smoke.py phase
// counters): the epilogues were most of a tile, from the BN vectors read from
// global at each use and from branches that the runtime-indexed selects of
// the transpose and the conditional t stores compiled to.
// Shared memory (bytes): t 33,792 per 64 channels (256 rows + 8 spare; the
// last plane 258 rows), x stages 32,768 each, the weight ring, the BN vectors
// (12*C, copied once per block), 8 per mbarrier:
//   C = 64:  t 33,024 + x 32,768 + all 6 pieces 45,056 + BN 768 + 64  = 111,680
//            (two blocks an SM)
//   C = 128: t 33,024 + x 2 x 32,768 + 8 x 16,384 ring + BN 1,536 + 88 = 231,256
//   C = 256: t 66,816 + x 2 x 32,768 + 5 x 16,384 ring + BN 3,072 + 64 = 217,408
// of the 232,448 a block may use.  Ragged tiles are masked by bounds; no
// divisibility rule on H, W.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include "hopper_common.cuh"

using namespace fconv;

namespace {

constexpr int kThreads = 256;              // two warpgroups: output rows y0, y0 + 1
constexpr int kTH = 2, kTW = 62;           // output tile
constexpr int kHW = kTW + 2;               // 64 halo columns
constexpr int kNPix = (kTH + 2) * kHW;     // 256 halo pixels
constexpr int kMT = kNPix / 64;            // 4 m64 tiles of the 1x1
constexpr int kXPlane = kNPix * 128;       // 32,768: an x slice (64 channels of the halo)
constexpr int kPlane = kXPlane + 8 * 128;  // 33,792: 64 channels of t, 8 spare rows
constexpr int kSmemMax = 232448;

template <int C>
struct Res {
  static constexpr int CM = C / 2;
  static constexpr int NS = C / 64;              // x slices = K slices of the 1x1
  static constexpr int XST = NS < 2 ? NS : 2;    // x stages
  static constexpr int NA = CM / 2;              // 1x1 output channels per warpgroup
  static constexpr int KB = 9 * CM;              // K of the 3x3
  static constexpr int NKS = (KB + 63) / 64;     // its 64-wide K slices
  static constexpr int RB = C < 128 ? C : 128;   // output channels of a 3x3 piece
  static constexpr int NH = C / RB;              // 3x3 pieces per K slice
  static constexpr int TAIL_STEPS = KB % 64 ? KB % 64 / 16 : 4;  // k-steps of the last slice
  static constexpr int P = NS + NKS * NH;        // weight pieces per tile: 6, 11, 40
  static constexpr int WA_BYTES = CM * 128, WB_BYTES = RB * 128;
  static constexpr int WST = WA_BYTES > WB_BYTES ? WA_BYTES : WB_BYTES;  // ring stage
  static constexpr int TPL = CM > 64 ? CM / 64 : 1;  // t planes
  // t planes of 256 + 8 rows; the last needs only the 258 the 3x3 reads
  static constexpr int T_BYTES = (TPL - 1) * kPlane + ((kTH + 1) * kHW + 2 + 64) * 128;
  static constexpr int BN_BYTES = 3 * C * 4;   // the BN vectors, copied once
  static constexpr int FIXED = XST * kXPlane + T_BYTES + BN_BYTES + (1 + XST) * 8;
  static constexpr int NST_FIT = (kSmemMax - FIXED) / (WST + 8);
  static constexpr int NST = P < NST_FIT ? P : NST_FIT;  // ring stages
  // every piece loaded once per block, packed (not in equal stages)
  static constexpr bool RESIDENT = NST == P;
  static constexpr int RING = RESIDENT ? NS * WA_BYTES + NKS * NH * WB_BYTES : NST * WST;
  static constexpr int X_OFF = RING;
  static constexpr int T_OFF = X_OFF + XST * kXPlane;
  static constexpr int BN_OFF = T_OFF + T_BYTES;
  // mbarriers: the ring stages', the BN copy's, the x stages'
  static constexpr int BAR_OFF = BN_OFF + BN_BYTES;
  static constexpr int SMEM = BAR_OFF + (NST + 1 + XST) * 8;
  static constexpr int PER_SM = SMEM <= kSmemMax / 2 - 512 ? 2 : 1;  // blocks an SM holds
  static_assert(SMEM <= kSmemMax, "shared memory");
  static_assert(NST >= 2, "ring");
};

// The 3x3's products over K slice s3 of a piece at b0 (STEPS 16-deep steps):
// K index k0 = (di*3 + dj)*C/2 + c0 reads t rows (wg + di)*64 + dj .. + 63,
// channels c0 .. c0 + 15 (plane c0 / 64)
template <int C, int STEPS>
__device__ __forceinline__ void mma3x3(float* acc, uint32_t ts, uint32_t b0, int wg, int s3) {
  constexpr int CM = C / 2;
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const int k0 = 64 * s3 + 16 * kk;
    const int tap = k0 / CM, c0 = k0 - tap * CM;
    const int di = tap / 3, dj = tap - 3 * di;
    const uint32_t a = ts + (c0 >> 6) * kPlane + ((wg + di) * kHW + dj) * 128 + (c0 & 63) * 2;
    wgmma<(C < 128 ? C : 128)>(acc, smem_desc(a), smem_desc(b0 + kk * 32), s3 > 0 || kk > 0);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, Res<C>::PER_SM)
res_block_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
                 const bf16* __restrict__ w, const float* __restrict__ bn,
                 bf16* __restrict__ out, int H, int W, int tiles_x, long long tiles_per_img,
                 long long tiles) {
  using R = Res<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const uint32_t xs = ring + R::X_OFF, ts = ring + R::T_OFF, bars = ring + R::BAR_OFF;
  const uint32_t xbars = bars + 8 * (R::NST + 1);  // one per x stage
  const float* sa = reinterpret_cast<const float*>(smem + R::BN_OFF);  // shared copies
  const float* ba = sa + R::CM;
  const float* sb = sa + C;
  const float* bb = sa + 2 * C;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const long long my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (my_tiles <= 0) return;
  const long long n_pieces = my_tiles * R::P;  // this block's pieces, in order
  PHASE_START();

  auto stage_addr = [&](long long gp) {
    const int j = (int)(gp % R::P);
    return R::RESIDENT ? ring + (j < R::NS ? j * R::WA_BYTES
                                           : R::NS * R::WA_BYTES + (j - R::NS) * R::WB_BYTES)
                       : ring + (int)(gp % R::NST) * R::WST;
  };
  // piece gp (of this block's sequence) is piece gp % P of a tile, in stage gp % NST
  auto issue_piece = [&](long long gp) {  // by thread 0
    const int j = (int)(gp % R::P), st = (int)(gp % R::NST);
    const bf16* src = j < R::NS ? w + (size_t)j * R::CM * 64
                                : w + (size_t)R::NS * R::CM * 64 + (size_t)(j - R::NS) * R::RB * 64;
    bulk_load(stage_addr(gp), src, j < R::NS ? R::WA_BYTES : R::WB_BYTES, bars + 8 * st);
  };
  auto wait_piece = [&](long long gp) {
    const uint32_t parity = R::RESIDENT ? 0u : (uint32_t)((gp / R::NST) & 1);
    mbar_wait(bars + 8 * (int)(gp % R::NST), parity);
  };
  // once piece gp has been read by both warpgroups, its stage takes gp + NST
  auto release = [&](long long gp) {
    if (!R::RESIDENT && tid == 0 && gp + R::NST < n_pieces) issue_piece(gp + R::NST);
  };
  auto tile_at = [&](long long it, int& n, int& y0, int& x0) {
    const long long t = blockIdx.x + it * gridDim.x;
    n = (int)(t / tiles_per_img);
    const int r = (int)(t - n * tiles_per_img);
    y0 = (r / tiles_x) * kTH;
    x0 = (r % tiles_x) * kTW;
  };
  // x slice s (channels 64s .. 64s+63) of the tile's halo into stage
  // s % XST: one tensor-map copy by thread 0, zeros outside the image.  The
  // u-th copy into a stage completes its barrier's phase u; a tile makes
  // NS / XST copies into each stage.
  auto issue_x = [&](int n, int y0, int x0, int s) {
    if (tid != 0) return;
    const int st = s % R::XST;
    mbar_expect_tx(xbars + 8 * st, kXPlane);
    tma_load_4d(xs + st * kXPlane, &xmap, 64 * s, x0 - 1, y0 - 1, n, xbars + 8 * st);
  };
  auto wait_x = [&](long long it, int s) {
    mbar_wait(xbars + 8 * (s % R::XST), (uint32_t)((it * (R::NS / R::XST) + s / R::XST) & 1));
  };

  if (tid == 0) {
    if (ring & 1023) __trap();  // the swizzle needs 1024-byte aligned regions
    for (int s = 0; s < R::NST + 1 + R::XST; ++s) mbar_init(bars + 8 * s);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(ring + R::BN_OFF, bn, R::BN_BYTES, bars + 8 * R::NST);
    for (long long gp = 0; gp < R::NST && gp < n_pieces; ++gp) issue_piece(gp);
  }
  mbar_wait(bars + 8 * R::NST, 0);
  int n, y0, x0;
  tile_at(0, n, y0, x0);
  for (int s = 0; s < R::XST; ++s) issue_x(n, y0, x0, s);

  for (long long it = 0; it < my_tiles; ++it) {
    const long long g0 = it * R::P;

    // ---- 1x1 over the halo list; warpgroup wg: t channels wg*NA .. +NA-1
    float acc1[kMT][R::NA / 2];
    for (int s = 0; s < R::NS; ++s) {
      wait_piece(g0 + s);
      wait_x(it, s);
      PHASE_MARK(0);
      const uint32_t a0 = xs + (s % R::XST) * kXPlane;
      const uint32_t b0 = stage_addr(g0 + s) + wg * R::NA * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          wgmma<R::NA>(acc1[mt], smem_desc(a0 + mt * 64 * 128 + kk * 32),
                       smem_desc(b0 + kk * 32), s > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) acc_fence<R::NA / 2>(acc1[mt]);
      __syncthreads();  // both warpgroups are done with slice s and piece s
      release(g0 + s);
      if (s + R::XST < R::NS) issue_x(n, y0, x0, s + R::XST);
      PHASE_MARK(1);
    }

    // ---- t = bf16(leaky(bn_a(.))), exactly zero outside the image.  Halo row
    // p = 64*mt + 16*w4 + g + 8*half, so p & 7 = g: column ch of row p sits in
    // the 16-byte chunk ((ch & 63) >> 3) ^ g, at byte 4q (ch & 7 = 2q)
    {
      uint32_t row[kMT][2], keep[kMT][2];  // keep: all ones inside the image
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 64 * mt + 16 * w4 + g + 8 * half;
          const int gy = y0 - 1 + p / kHW, gx = x0 - 1 + p % kHW;
          row[mt][half] = ts + p * 128 + 4 * q;
          keep[mt][half] = gy >= 0 && gy < H && gx >= 0 && gx < W ? 0xffffffffu : 0u;
        }
#pragma unroll
      for (int t = 0; t < R::NA / 8; ++t) {
        const int ch = wg * R::NA + 8 * t + 2 * q;
        const float2 s2 = *reinterpret_cast<const float2*>(sa + ch);
        const float2 b2 = *reinterpret_cast<const float2*>(ba + ch);
        const uint32_t col = (ch >> 6) * kPlane + ((((ch & 63) >> 3) ^ g) << 4);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* a = acc1[mt] + 4 * t + 2 * half;
            st_shared_u32(row[mt][half] + col,
                          pack2(bn_leaky(a[0], s2.x, b2.x), bn_leaky(a[1], s2.y, b2.y)) &
                              keep[mt][half]);
          }
      }
    }
    fence_proxy_async();
    __syncthreads();  // t is complete
    PHASE_MARK(2);

    // the next tile's first slices load while the 3x3 runs
    int nn = n, ny0 = y0, nx0 = x0;
    if (it + 1 < my_tiles) {
      tile_at(it + 1, nn, ny0, nx0);
      for (int s = 0; s < R::XST; ++s) issue_x(nn, ny0, nx0, s);
    }
    PHASE_MARK(6);

    // ---- 3x3 over t, RB output channels at a time (so 64 accumulator
    // registers, not 128, at C = 256): warpgroup wg computes output row y0 + wg
    const int gy = y0 + wg;
#pragma unroll 1
    for (int h = 0; h < R::NH; ++h) {
      // the skip values of this row and channel block load while the products
      // run: lane's pixel j = 16*w4 + g (+ 8), channels chg + 8q .. + 7
      uint4 skip[R::RB / 32][2];
#pragma unroll
      for (int grp = 0; grp < R::RB / 32; ++grp)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * w4 + g + 8 * half, gx = x0 + j;
          const size_t at = (((size_t)n * H + gy) * W + gx) * C + h * R::RB + grp * 32 + 8 * q;
          skip[grp][half] = j < kTW && gy < H && gx < W ? ld_early16(x + at)
                                                        : make_uint4(0u, 0u, 0u, 0u);
        }
      PHASE_MARK(7);
      float acc3[R::RB / 2];
      for (int s3 = 0; s3 < R::NKS; ++s3) {
        const long long gp = g0 + R::NS + h * R::NKS + s3;
        wait_piece(gp);
        PHASE_MARK(3);
        const uint32_t b0 = stage_addr(gp);
        wgmma_fence();
        if (s3 < R::KB / 64)  // a whole slice; else the last, partial one (C = 64)
          mma3x3<C, 4>(acc3, ts, b0, wg, s3);
        else
          mma3x3<C, R::TAIL_STEPS>(acc3, ts, b0, wg, s3);
        wgmma_commit();
        wgmma_wait<1>();  // this warpgroup's product of piece gp - 1 has retired
        acc_fence<R::RB / 2>(acc3);
        __syncthreads();
        if (h > 0 || s3 > 0) release(gp - 1);
        PHASE_MARK(4);
      }
      wgmma_wait<0>();
      acc_fence<R::RB / 2>(acc3);
      if (h == R::NH - 1) {  // the tile's last piece is free
        __syncthreads();
        release(g0 + R::P - 1);
      }
      PHASE_MARK(4);

      // ---- y = bf16(leaky(bn_b(.)) + x): after the transpose a lane holds
      // eight consecutive channels of its pixel; columns j >= 62 are not stored
#pragma unroll
      for (int grp = 0; grp < R::RB / 32; ++grp) {
        const int chg = h * R::RB + grp * 32;
        float sc[4][2], bi[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 s2 = *reinterpret_cast<const float2*>(sb + chg + 8 * t + 2 * q);
          const float2 b2 = *reinterpret_cast<const float2*>(bb + chg + 8 * t + 2 * q);
          sc[t][0] = s2.x, sc[t][1] = s2.y, bi[t][0] = b2.x, bi[t][1] = b2.y;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float* a = acc3 + (grp * 4 + t) * 4 + 2 * half;
            lo[t] = __float_as_uint(bn_leaky(a[0], sc[t][0], bi[t][0]));
            hi[t] = __float_as_uint(bn_leaky(a[1], sc[t][1], bi[t][1]));
          }
          quad_transpose(lo, lane);  // now channels 8q + 2p of the group
          quad_transpose(hi, lane);  // and 8q + 2p + 1
          float v[8];
          unpack8(skip[grp][half], v);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[2 * p] = __fadd_rn(__uint_as_float(lo[p]), v[2 * p]);
            v[2 * p + 1] = __fadd_rn(__uint_as_float(hi[p]), v[2 * p + 1]);
          }
          const int j = 16 * w4 + g + 8 * half, gx = x0 + j;
          if (j < kTW && gy < H && gx < W)
            *reinterpret_cast<uint4*>(out + (((size_t)n * H + gy) * W + gx) * C + chg + 8 * q) =
                pack8(v);
        }
      }
      PHASE_MARK(5);
    }
    n = nn, y0 = ny0, x0 = nx0;
  }
  PHASE_FLUSH();
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of x (N, H, W, C) bf16 whose box is one x slice of a tile's
// halo: 64 channels x 64 columns x 4 rows x 1 image, 128-byte swizzled as
// the 1x1's descriptors read it.  0 on success.
int x_tensor_map(CUtensorMap* map, const void* x, int N, int H, int W, int C) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return -2;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, kHW, kTH + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int C>
int launch(const void* x, const void* w, const float* bn, void* out, int N, int H, int W,
           cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = request_smem(res_block_kernel<C>, Res<C>::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap;
  const int map_err = x_tensor_map(&xmap, x, N, H, W, C);
  if (map_err != 0) return map_err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const long long per_img = (long long)((H + kTH - 1) / kTH) * tiles_x;
  res_block_kernel<C><<<persistent_blocks(per_img * N, Res<C>::PER_SM), kThreads, Res<C>::SMEM,
                        stream>>>(
      xmap, (const bf16*)x, (const bf16*)w, bn, (bf16*)out, H, W, tiles_x, per_img, per_img * N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success); -1 for a channel count
// the kernel is not built for, -2 / -3 if the driver's tensor-map encoder is
// missing / refuses x.
extern "C" int fused_res_block_launch(const void* x, const void* w, const float* bn, void* out,
                                      int N, int H, int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch<64>(x, w, bn, out, N, H, W, st);
    case 128: return launch<128>(x, w, bn, out, N, H, W, st);
    case 256: return launch<256>(x, w, bn, out, N, H, W, st);
    default: return -1;
  }
}
