// Global epistemic moment sums -> decoded epistemic rows.
//
// Replaces the TPU kernel
// bayesian_yolov3_tpu/ops/pallas_epistemic.py:_finalize_kernel (behind
// epistemic_finalize).  Its input is the all-reduce over the ranks of the
// sums that epistemic_moments.cu writes.
//
// Input  m    (B, M, total) f32, M = 21+C sums over ALL T samples,
//             total = n_imgs*h*w, anchors minor
//        pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (n_imgs, B*h*w, 21+C) f32, rows prior-major, then row-major
//             cells, inside each image: the rows of epistemic_decode.cu.
//
// Bound: bytes, and at the main path's size launch latency: 11.1 MB in and
// 11.1 MB out per 1024x1920 image at C=2 (0.0066 ms at 3.35 TB/s).
// Design: one thread per (image, prior, cell), the row computed by
// finalize_row of decode_common.cuh — the same code that ends
// epistemic_decode.cu, scaled by the GLOBAL T.  The sums are read coalesced
// along the cell axis.  A block covers FIN_BLOCK consecutive cells of one
// (image, prior), whose output rows are one contiguous run: it stages them
// in shared memory (odd row pitch, no bank conflicts) and writes the run
// back with consecutive threads on consecutive addresses.  The ragged last
// block of a grid is masked.
// Compile WITHOUT --use_fast_math (see decode_common.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define FIN_BLOCK 128
#define FIN_MAX_C 8

template <int C>
__global__ void __launch_bounds__(FIN_BLOCK)
epistemic_finalize_kernel(const float* __restrict__ m, const float* __restrict__ pri,
                          float* __restrict__ out, int B, int n_imgs, int h, int w,
                          int T, int layer_id) {
  constexpr int M = 21 + C;
  constexpr int W = 21 + C;
  constexpr int PITCH = W | 1;
  __shared__ float tile[FIN_BLOCK * PITCH];

  const int hw = h * w;
  const int nbp = blockIdx.y;  // n * B + b: the output's (image, prior) run
  const int n = nbp / B;
  const int b = nbp - n * B;
  const int cell0 = blockIdx.x * FIN_BLOCK;
  const int cell = cell0 + threadIdx.x;

  if (cell < hw) {
    const size_t total = (size_t)n_imgs * hw;
    const float* mp = m + (size_t)b * M * total + (size_t)n * hw + cell;
    float s[M];
#pragma unroll
    for (int k = 0; k < M; ++k) s[k] = mp[k * total];
    finalize_row<C>(s, T, cell, h, w, pri[2 * b + 0], pri[2 * b + 1], layer_id, b,
                    tile + threadIdx.x * PITCH);
  }
  __syncthreads();

  // coalesced write-back of the block's contiguous run of rows
  const int rows = min(FIN_BLOCK, hw - cell0);
  float* o = out + ((size_t)nbp * hw + cell0) * W;
  for (int i = threadIdx.x; i < rows * W; i += FIN_BLOCK) {
    const int row = i / W;
    o[i] = tile[row * PITCH + (i - row * W)];
  }
}

template <int C>
static void launch(const float* m, const float* pri, float* out, int B, int n_imgs,
                   int h, int w, int T, int layer_id, cudaStream_t stream) {
  const int hw = h * w;
  dim3 grid((unsigned)((hw + FIN_BLOCK - 1) / FIN_BLOCK), (unsigned)(n_imgs * B));
  epistemic_finalize_kernel<C><<<grid, FIN_BLOCK, 0, stream>>>(
      m, pri, out, B, n_imgs, h, w, T, layer_id);
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, FIN_MAX_C].
extern "C" int epistemic_finalize_launch(const float* m, const float* pri, float* out,
                                         int B, int n_imgs, int h, int w, int T, int C,
                                         int layer_id, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 2: launch<2>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 3: launch<3>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 4: launch<4>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 5: launch<5>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 6: launch<6>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 7: launch<7>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    case 8: launch<8>(m, pri, out, B, n_imgs, h, w, T, layer_id, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_finalize_max_classes() { return FIN_MAX_C; }
