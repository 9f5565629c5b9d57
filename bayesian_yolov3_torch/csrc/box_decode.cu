// Per-sample box decode of the batched standard / aleatoric heads.
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_decode.py:_kernel
// (behind fused_box_decode_cf / fused_box_decode_all_scales).
//
// Input  x    (B*chpp, nb, h*w) f32, cells minor; chpp = 5+C (standard) or
//             2*(5+C) (aleatoric: loc, log_loc_var, obj, log_obj_stddev,
//             cls, log_cls_stddev — the two stddev groups are not read)
//        pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (nb, B*h*w, W) f32, W = 7+C (standard) or 14+C (aleatoric);
//             rows prior-major, then row-major cells, inside each image.
//
// Bound: bytes.  Each thread reads 5+C (standard) or 9+C (aleatoric) floats
// and writes W, with a few dozen flops in between; at 1024x1920, batch 11,
// C=2 that is ~100 MB (aleatoric) for ~0.03 ms of HBM time.
// Design: one thread per (image, prior, cell), cells the fastest index, so
// for a fixed channel neighbouring threads read neighbouring floats.  A
// block covers BOX_BLOCK consecutive cells of one (image, prior), whose
// output rows form one contiguous run out[n, b*hw + cell0 ...]: the block
// stages its rows in shared memory (odd row pitch, no bank conflicts) and
// writes the run back with consecutive threads on consecutive addresses.
// No tiling rule on h*w: the ragged last block is masked.
// The corner decode (decode_corners) and the softmax come from
// decode_common.cuh, shared with the epistemic kernels; the variance product
// uses __fmul_rn so no FMA contraction changes a rounding.

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define BOX_BLOCK 128
#define BOX_MAX_C 8

template <bool ALEATORIC, int C>
__global__ void __launch_bounds__(BOX_BLOCK)
box_decode_kernel(const float* __restrict__ x, const float* __restrict__ pri,
                  float* __restrict__ out, int B, int nb, int h, int w,
                  int layer_id) {
  constexpr int CHPP = ALEATORIC ? 2 * (5 + C) : 5 + C;
  constexpr int W = ALEATORIC ? 14 + C : 7 + C;
  constexpr int PITCH = W | 1;
  constexpr int OBJ = ALEATORIC ? 8 : 4;   // objectness logit channel
  constexpr int CLS = ALEATORIC ? 10 : 5;  // first class logit channel
  __shared__ float tile[BOX_BLOCK * PITCH];

  const int hw = h * w;
  const int nbp = blockIdx.y;  // n * B + b: the output's (image, prior) run
  const int n = nbp / B;
  const int b = nbp - n * B;
  const int cell0 = blockIdx.x * BOX_BLOCK;
  const int cell = cell0 + threadIdx.x;

  if (cell < hw) {
    const size_t ch_stride = (size_t)nb * hw;
    const float* xp = x + (size_t)b * CHPP * ch_stride + (size_t)n * hw + cell;
    float* r = tile + threadIdx.x * PITCH;

    decode_corners(xp[0], xp[ch_stride], xp[2 * ch_stride], xp[3 * ch_stride], cell, h, w,
                   pri[2 * b + 0], pri[2 * b + 1], r);

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
    r[k++] = (float)layer_id;
    r[k] = (float)b;
  }
  __syncthreads();

  // coalesced write-back of the block's contiguous run of rows
  const int rows = min(BOX_BLOCK, hw - cell0);
  float* o = out + ((size_t)nbp * hw + cell0) * W;
  for (int i = threadIdx.x; i < rows * W; i += BOX_BLOCK) {
    const int row = i / W;
    o[i] = tile[row * PITCH + (i - row * W)];
  }
}

template <bool ALEATORIC, int C>
static void launch(const float* x, const float* pri, float* out, int B, int nb,
                   int h, int w, int layer_id, cudaStream_t stream) {
  const int hw = h * w;
  dim3 grid((unsigned)((hw + BOX_BLOCK - 1) / BOX_BLOCK), (unsigned)(nb * B));
  box_decode_kernel<ALEATORIC, C><<<grid, BOX_BLOCK, 0, stream>>>(
      x, pri, out, B, nb, h, w, layer_id);
}

template <bool ALEATORIC>
static int dispatch(const float* x, const float* pri, float* out, int B, int nb,
                    int h, int w, int C, int layer_id, cudaStream_t st) {
  switch (C) {
    case 1: launch<ALEATORIC, 1>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 2: launch<ALEATORIC, 2>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 3: launch<ALEATORIC, 3>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 4: launch<ALEATORIC, 4>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 5: launch<ALEATORIC, 5>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 6: launch<ALEATORIC, 6>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 7: launch<ALEATORIC, 7>(x, pri, out, B, nb, h, w, layer_id, st); break;
    case 8: launch<ALEATORIC, 8>(x, pri, out, B, nb, h, w, layer_id, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, BOX_MAX_C].
extern "C" int box_decode_launch(const float* x, const float* pri, float* out,
                                 int B, int nb, int h, int w, int C,
                                 int layer_id, int aleatoric, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return aleatoric ? dispatch<true>(x, pri, out, B, nb, h, w, C, layer_id, st)
                   : dispatch<false>(x, pri, out, B, nb, h, w, C, layer_id, st);
}

extern "C" int box_decode_max_classes() { return BOX_MAX_C; }
