// The scale table of the one-launch decode kernels (box_decode.cu,
// epistemic_finalize.cu): up to three scales of a model's heads, passed by
// value as a kernel parameter, so a launch needs no table in device memory
// and no copy to the card.  ops/decode.py:scale_plan computes the same
// offsets; the wrappers fill the table from it (ops/cuda_decode.py:
// ScaleTable mirrors this struct, its size checked when a library loads).
//
// Grid: x walks the scales' cell blocks one scale after the other (scale s
// owns blocks [first_block[s], first_block[s+1])), y the (image, prior)
// pairs n * B + b.  A block covers SCALE_BLOCK consecutive cells of one
// (image, prior, scale), so it never spans two scales, and its output rows
// form one contiguous run of an image's concatenated rows:
//   out row = n * rows + row_off[s] + b * h[s] * w[s] + cell
// (per image: every row of scale 0, then scale 1, then scale 2; inside a
// scale prior-major, then row-major cells — the reference concat order).
// The last block of each scale is ragged and masked by its own scale's
// cell count.
#pragma once

#include <cuda_runtime.h>

#define MAX_SCALES 3
#define SCALE_BLOCK 128  // cells of one (image, prior, scale) a block covers

struct ScaleTable {
  const float* x[MAX_SCALES];    // the scale's input
  const float* pri[MAX_SCALES];  // its (B, 2) priors (prior_h, prior_w) on the card
  int h[MAX_SCALES];
  int w[MAX_SCALES];
  int layer_id[MAX_SCALES];
  int first_block[MAX_SCALES + 1];  // [n_scales]: the grid's x extent
  int row_off[MAX_SCALES];          // first row of the scale in an image's rows
  int n_scales;
  int rows;  // rows of one image: B * sum of h * w
};

// One scale of the table, as a block reads it.
struct Scale {
  const float* x;
  const float* pri;
  int h, w, layer_id, first_block, row_off;
};

// This block's scale.  The loop is unrolled, so every field is read at a
// constant index (no dynamic indexing of the parameter space), and the
// choice is uniform over the block.
__device__ __forceinline__ Scale block_scale(const ScaleTable& t) {
  const int bx = (int)blockIdx.x;
  Scale s = Scale{t.x[0], t.pri[0], t.h[0], t.w[0], t.layer_id[0], t.first_block[0],
                  t.row_off[0]};
#pragma unroll
  for (int k = 1; k < MAX_SCALES; ++k) {
    if (k < t.n_scales && bx >= t.first_block[k]) {
      s = Scale{t.x[k], t.pri[k], t.h[k], t.w[k], t.layer_id[k], t.first_block[k],
                t.row_off[k]};
    }
  }
  return s;
}

// The launch grid of a table over nbp (image, prior) pairs.
inline dim3 scale_grid(const ScaleTable& t, int nbp) {
  return dim3((unsigned)t.first_block[t.n_scales], (unsigned)nbp);
}

// The block's W-float rows, staged in shared memory at an odd pitch, written
// back as one contiguous run with consecutive threads on consecutive
// addresses.
template <int W, int PITCH>
__device__ __forceinline__ void write_run(const float* __restrict__ tile, float* __restrict__ o,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * W; i += SCALE_BLOCK) {
    const int row = i / W;
    o[i] = tile[row * PITCH + (i - row * W)];
  }
}
