// Global epistemic moment sums -> decoded epistemic rows, every scale of a
// frame in one launch.
//
// Replaces the TPU kernel
// bayesian_yolov3_tpu/ops/pallas_epistemic.py:_finalize_kernel (behind
// epistemic_finalize).  Its input is the all-reduce over the ranks of the
// sums that epistemic_moments.cu writes.
//
// Input  per scale s of the table (scale_table.cuh):
//          m    (B, M, total) f32, M = 21+C sums over ALL T samples,
//               total = n_imgs*h*w, anchors minor; on the mc path the three
//               scales' blocks lie one after the other in one packed buffer,
//               the one all-reduced tensor of a frame
//          pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (n_imgs, rows, 21+C) f32, rows = B * sum h*w: per image the
//             scales' rows one after the other, each prior-major, then
//             row-major cells — the rows of epistemic_decode.cu, concatenated
//             in the reference order, so no copy follows the launch.
//
// Bound: bytes, and at the main path's size launch latency: 11.1 MB in and
// 11.1 MB out per 1024x1920 image at C=2 (0.0066 ms at 3.35 TB/s).  Three
// launches, one a scale, paid three launches and tails for a few
// microseconds of streaming; one launch over the table pays one.
// Design: one thread per (image, prior, cell), the row computed by
// finalize_row of decode_common.cuh — the same code that ends
// epistemic_decode.cu, scaled by the GLOBAL T, so a frame's rows equal the
// one-shot decode's bit for bit when the sums add in its order.  The sums
// are read coalesced along the cell axis.  A block covers SCALE_BLOCK
// consecutive cells of one (image, prior, scale), whose output rows are one
// contiguous run: it stages them in shared memory (odd row pitch, no bank
// conflicts) and writes the run back with consecutive threads on
// consecutive addresses.  Each scale's ragged last block is masked.
// Compile WITHOUT --use_fast_math (see decode_common.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"
#include "scale_table.cuh"

#define FIN_MAX_C 8

template <int C>
__global__ void __launch_bounds__(SCALE_BLOCK)
epistemic_finalize_kernel(const __grid_constant__ ScaleTable t, float* __restrict__ out,
                          int B, int n_imgs, int T) {
  constexpr int M = 21 + C;
  constexpr int W = 21 + C;
  constexpr int PITCH = W | 1;
  __shared__ float tile[SCALE_BLOCK * PITCH];

  const Scale sc = block_scale(t);
  const int hw = sc.h * sc.w;
  const int nbp = blockIdx.y;  // n * B + b
  const int n = nbp / B;
  const int b = nbp - n * B;
  const int cell0 = ((int)blockIdx.x - sc.first_block) * SCALE_BLOCK;
  const int cell = cell0 + threadIdx.x;

  if (cell < hw) {
    const size_t total = (size_t)n_imgs * hw;
    const float* mp = sc.x + (size_t)b * M * total + (size_t)n * hw + cell;
    float s[M];
#pragma unroll
    for (int k = 0; k < M; ++k) s[k] = mp[k * total];
    finalize_row<C>(s, T, cell, sc.h, sc.w, sc.pri[2 * b + 0], sc.pri[2 * b + 1], sc.layer_id,
                    b, tile + threadIdx.x * PITCH);
  }
  __syncthreads();

  // the block's contiguous run of rows in the image's concatenated rows
  write_run<W, PITCH>(tile, out + ((size_t)n * t.rows + sc.row_off + (size_t)b * hw + cell0) * W,
                      min(SCALE_BLOCK, hw - cell0));
}

template <int C>
static void launch(const ScaleTable& t, float* out, int B, int n_imgs, int T,
                   cudaStream_t stream) {
  epistemic_finalize_kernel<C><<<scale_grid(t, n_imgs * B), SCALE_BLOCK, 0, stream>>>(
      t, out, B, n_imgs, T);
}

// One launch over the scales of *table (host memory; copied into the kernel's
// parameters).  Returns the cudaError_t of the launch (0 = success); -1 for
// a class count outside [1, FIN_MAX_C], -2 for a table of no scale or more
// than MAX_SCALES.
extern "C" int epistemic_finalize_launch(const ScaleTable* table, float* out, int B,
                                         int n_imgs, int T, int C, void* stream) {
  if (table->n_scales < 1 || table->n_scales > MAX_SCALES) return -2;
  const ScaleTable& t = *table;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(t, out, B, n_imgs, T, st); break;
    case 2: launch<2>(t, out, B, n_imgs, T, st); break;
    case 3: launch<3>(t, out, B, n_imgs, T, st); break;
    case 4: launch<4>(t, out, B, n_imgs, T, st); break;
    case 5: launch<5>(t, out, B, n_imgs, T, st); break;
    case 6: launch<6>(t, out, B, n_imgs, T, st); break;
    case 7: launch<7>(t, out, B, n_imgs, T, st); break;
    case 8: launch<8>(t, out, B, n_imgs, T, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_finalize_max_classes() { return FIN_MAX_C; }
extern "C" int epistemic_finalize_table_bytes() { return (int)sizeof(ScaleTable); }
extern "C" int epistemic_finalize_scale_block() { return SCALE_BLOCK; }
