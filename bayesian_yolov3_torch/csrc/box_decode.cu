// Per-sample box decode of the batched standard / aleatoric heads, every
// scale of a batch in one launch.
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_decode.py:_kernel
// (behind fused_box_decode_cf / fused_box_decode_all_scales).
//
// Input  per scale s of the table (scale_table.cuh):
//          x    (B*chpp, nb, h*w) f32, cells minor; chpp = 5+C (standard) or
//               2*(5+C) (aleatoric: loc, log_loc_var, obj, log_obj_stddev,
//               cls, log_cls_stddev — the two stddev groups are not read)
//          pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (nb, rows, W) f32, rows = B * sum h*w, W = 7+C (standard) or
//             14+C (aleatoric): per image the scales' rows one after the
//             other, each prior-major, then row-major cells — the reference
//             concat order, so no copy follows the launch.
//
// Bound: bytes.  Each thread reads 5+C (standard) or 9+C (aleatoric) floats
// and writes W, with a few dozen flops in between; at 1024x1920, batch 11,
// C=2 that is 143.7 MB (aleatoric) for 0.043 ms of HBM time.  Three
// launches, one a scale, paid a launch and a tail each and left a cat of the
// rows (as many bytes again) to the caller; one launch over the table pays
// one of each and writes the rows where they end.
// Design: one thread per (image, prior, cell), cells the fastest index, so
// for a fixed channel neighbouring threads read neighbouring floats.  A
// block covers SCALE_BLOCK consecutive cells of one (image, prior, scale),
// whose output rows form one contiguous run: the block stages its rows in
// shared memory (odd row pitch, no bank conflicts) and writes the run back
// with consecutive threads on consecutive addresses.  No tiling rule on
// h*w: each scale's ragged last block is masked.
// The corner decode (decode_corners) and the softmax come from
// decode_common.cuh, shared with the epistemic kernels; the variance product
// uses __fmul_rn so no FMA contraction changes a rounding.

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"
#include "scale_table.cuh"

#define BOX_MAX_C 8

template <bool ALEATORIC, int C>
__global__ void __launch_bounds__(SCALE_BLOCK)
box_decode_kernel(const __grid_constant__ ScaleTable t, float* __restrict__ out, int B,
                  int nb) {
  constexpr int CHPP = ALEATORIC ? 2 * (5 + C) : 5 + C;
  constexpr int W = ALEATORIC ? 14 + C : 7 + C;
  constexpr int PITCH = W | 1;
  constexpr int OBJ = ALEATORIC ? 8 : 4;   // objectness logit channel
  constexpr int CLS = ALEATORIC ? 10 : 5;  // first class logit channel
  __shared__ float tile[SCALE_BLOCK * PITCH];

  const Scale sc = block_scale(t);
  const int hw = sc.h * sc.w;
  const int nbp = blockIdx.y;  // n * B + b
  const int n = nbp / B;
  const int b = nbp - n * B;
  const int cell0 = ((int)blockIdx.x - sc.first_block) * SCALE_BLOCK;
  const int cell = cell0 + threadIdx.x;

  if (cell < hw) {
    const size_t ch_stride = (size_t)nb * hw;
    const float* xp = sc.x + (size_t)b * CHPP * ch_stride + (size_t)n * hw + cell;
    float* r = tile + threadIdx.x * PITCH;

    decode_corners(xp[0], xp[ch_stride], xp[2 * ch_stride], xp[3 * ch_stride], cell, sc.h,
                   sc.w, sc.pri[2 * b + 0], sc.pri[2 * b + 1], r);

    const float obj = sigmoidf(xp[OBJ * ch_stride]);
    float lg[C];
#pragma unroll
    for (int c = 0; c < C; ++c) lg[c] = xp[(CLS + c) * ch_stride];
    softmax_inplace<C>(lg);  // class probabilities

    int k = 4;
    if constexpr (ALEATORIC) {
      float total = 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = expf(xp[(4 + j) * ch_stride]);
        r[k++] = v;
        total = j ? __fmul_rn(total, v) : v;
      }
      r[k++] = total;
      r[k++] = obj;
      r[k++] = logistic_entropy(obj);
      float ent = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        r[k++] = lg[c];
        ent -= xlogx(lg[c]);
      }
      r[k++] = ent;
    } else {
      r[k++] = obj;
#pragma unroll
      for (int c = 0; c < C; ++c) r[k++] = lg[c];
    }
    r[k++] = (float)sc.layer_id;
    r[k] = (float)b;
  }
  __syncthreads();

  // the block's contiguous run of rows in the image's concatenated rows
  write_run<W, PITCH>(tile, out + ((size_t)n * t.rows + sc.row_off + (size_t)b * hw + cell0) * W,
                      min(SCALE_BLOCK, hw - cell0));
}

template <bool ALEATORIC, int C>
static void launch(const ScaleTable& t, float* out, int B, int nb, cudaStream_t stream) {
  box_decode_kernel<ALEATORIC, C><<<scale_grid(t, nb * B), SCALE_BLOCK, 0, stream>>>(
      t, out, B, nb);
}

template <bool ALEATORIC>
static int dispatch(const ScaleTable& t, float* out, int B, int nb, int C, cudaStream_t st) {
  switch (C) {
    case 1: launch<ALEATORIC, 1>(t, out, B, nb, st); break;
    case 2: launch<ALEATORIC, 2>(t, out, B, nb, st); break;
    case 3: launch<ALEATORIC, 3>(t, out, B, nb, st); break;
    case 4: launch<ALEATORIC, 4>(t, out, B, nb, st); break;
    case 5: launch<ALEATORIC, 5>(t, out, B, nb, st); break;
    case 6: launch<ALEATORIC, 6>(t, out, B, nb, st); break;
    case 7: launch<ALEATORIC, 7>(t, out, B, nb, st); break;
    case 8: launch<ALEATORIC, 8>(t, out, B, nb, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// One launch over the scales of *table (host memory; copied into the kernel's
// parameters).  Returns the cudaError_t of the launch (0 = success); -1 for
// a class count outside [1, BOX_MAX_C], -2 for a table of no scale or more
// than MAX_SCALES.
extern "C" int box_decode_launch(const ScaleTable* table, float* out, int B, int nb, int C,
                                 int aleatoric, void* stream) {
  if (table->n_scales < 1 || table->n_scales > MAX_SCALES) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return aleatoric ? dispatch<true>(*table, out, B, nb, C, st)
                   : dispatch<false>(*table, out, B, nb, C, st);
}

extern "C" int box_decode_max_classes() { return BOX_MAX_C; }
extern "C" int box_decode_table_bytes() { return (int)sizeof(ScaleTable); }
extern "C" int box_decode_scale_block() { return SCALE_BLOCK; }
