// Epistemic statistics + bbox decode in one pass over the raw MC-sample heads.
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_epistemic.py:_kernel
// (behind fused_epistemic_decode_cf_batched / fused_epistemic_decode_cf).
//
// Input  x    (B*chpp, T, total) f32, total = n_imgs*h*w, anchors minor
//        pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (n_imgs, B*h*w, 21+C) f32, rows prior-major then row-major cells.
//
// Bound: bytes.  Every input element is read exactly once and reduced over T
// in registers; at 1024x1920, T=30, C=2 that is ~203 MB in and ~11 MB out per
// image against a few hundred flops per anchor-sample.
// Design: one thread per (prior, anchor).  For a fixed channel and sample,
// neighbouring threads read neighbouring anchors, so every load is coalesced.
// The sums and the row come from add_sample_moments / finalize_row of
// decode_common.cuh, which the split form (epistemic_moments.cu, then
// epistemic_finalize.cu) uses too.
// The 21+C output values of a thread are strided by the row width in memory,
// so the block stages its rows in shared memory and writes them back as one
// contiguous run.  No tiling rule on total: the ragged edge is masked.
// Compile WITHOUT --use_fast_math: expf/logf/division semantics matter for
// the saturated-probability entropies.

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define EPI_BLOCK 128
#define EPI_MAX_C 8

template <int C>
__global__ void __launch_bounds__(EPI_BLOCK)
epistemic_decode_kernel(const float* __restrict__ x,
                        const float* __restrict__ pri,
                        float* __restrict__ out,
                        int B, int T, int n_imgs, int h, int w, int layer_id) {
  constexpr int CHPP = 2 * (5 + C);
  constexpr int W = 21 + C;
  __shared__ float tile[EPI_BLOCK * W];

  const long long hw = (long long)h * w;
  const long long total = (long long)n_imgs * hw;
  const int b = blockIdx.y;
  const long long a0 = (long long)blockIdx.x * EPI_BLOCK;
  const long long a = a0 + threadIdx.x;

  if (a < total) {
    // channel ch, sample t of this prior: xb[(ch*T + t)*total + a]
    const float* xb = x + (size_t)b * CHPP * T * total + a;
    const size_t ch_stride = (size_t)T * total;
    float s[W];
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = 0.f;
    for (int t = 0; t < T; ++t) add_sample_moments<C>(xb + (size_t)t * total, ch_stride, s);
    finalize_row<C>(s, T, (int)(a % hw), h, w, pri[2 * b + 0], pri[2 * b + 1],
                    layer_id, b, tile + threadIdx.x * W);
  }
  __syncthreads();

  // coalesced write-back: consecutive i -> consecutive addresses inside an image
  for (int i = threadIdx.x; i < EPI_BLOCK * W; i += EPI_BLOCK) {
    const int row = i / W;
    const int col = i - row * W;
    const long long aa = a0 + row;
    if (aa < total) {
      const long long img = aa / hw;
      const long long cell = aa - img * hw;
      out[((size_t)img * B * hw + (size_t)b * hw + cell) * W + col] = tile[i];
    }
  }
}

template <int C>
static void launch(const float* x, const float* pri, float* out, int B, int T,
                   int n_imgs, int h, int w, int layer_id, cudaStream_t stream) {
  const long long total = (long long)n_imgs * h * w;
  dim3 grid((unsigned)((total + EPI_BLOCK - 1) / EPI_BLOCK), (unsigned)B);
  epistemic_decode_kernel<C><<<grid, EPI_BLOCK, 0, stream>>>(
      x, pri, out, B, T, n_imgs, h, w, layer_id);
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, EPI_MAX_C].
extern "C" int epistemic_decode_launch(const float* x, const float* pri,
                                       float* out, int B, int T, int n_imgs,
                                       int h, int w, int C, int layer_id,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 2: launch<2>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 3: launch<3>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 4: launch<4>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 5: launch<5>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 6: launch<6>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 7: launch<7>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    case 8: launch<8>(x, pri, out, B, T, n_imgs, h, w, layer_id, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_decode_max_classes() { return EPI_MAX_C; }
