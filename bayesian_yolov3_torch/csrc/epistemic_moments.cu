// Partial epistemic moment sums over the MC samples that one rank holds.
//
// Replaces the TPU kernel
// bayesian_yolov3_tpu/ops/pallas_epistemic.py:_moments_kernel (behind
// epistemic_moments_cf).  The sums of every rank are all-reduced and then
// finalized by epistemic_finalize.cu; together they compute what
// epistemic_decode.cu computes in one pass.
//
// Input  x    (B*chpp, T_local, total) f32, total = n_imgs*h*w, anchors minor
//             (the detection_conv_cf layout), chpp = 2*(5+C)
// Output out  (B, M, total) f32, M = 21+C unscaled sums in the row layout of
//             decode_common.cuh (add_sample_moments), anchors minor.
//
// Bound: bytes.  Each thread reads the 9+C channels the function uses (loc,
// log_loc_var, obj, cls; not the stddev groups) of T_local samples once and
// writes M sums; at 1024x1920, T_local=30, C=2 that is 159.7 MB in and
// 11.1 MB out per image (0.051 ms at 3.35 TB/s), against a few dozen flops
// per anchor-sample.
// Design: one thread per (prior, anchor), the samples reduced in registers.
// For a fixed channel and sample, neighbouring threads read neighbouring
// anchors, and for a fixed sum they write neighbouring anchors: every load
// and store is coalesced without staging.  No tiling rule on total: the
// ragged edge is masked.
// Compile WITHOUT --use_fast_math (see decode_common.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define MOM_BLOCK 128
#define MOM_MAX_C 8

template <int C>
__global__ void __launch_bounds__(MOM_BLOCK)
epistemic_moments_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int T, long long total) {
  constexpr int CHPP = 2 * (5 + C);
  constexpr int M = 21 + C;
  const int b = blockIdx.y;
  const long long a = (long long)blockIdx.x * MOM_BLOCK + threadIdx.x;
  if (a >= total) return;

  // channel ch, sample t of this prior: xb[(ch*T + t)*total]
  const size_t ch_stride = (size_t)T * total;
  const float* xb = x + (size_t)b * CHPP * ch_stride + a;
  float s[M];
#pragma unroll
  for (int k = 0; k < M; ++k) s[k] = 0.f;
  for (int t = 0; t < T; ++t) add_sample_moments<C>(xb + (size_t)t * total, ch_stride, s);

  float* ob = out + (size_t)b * M * total + a;
#pragma unroll
  for (int k = 0; k < M; ++k) ob[(size_t)k * total] = s[k];
}

template <int C>
static void launch(const float* x, float* out, int B, int T, long long total,
                   cudaStream_t stream) {
  dim3 grid((unsigned)((total + MOM_BLOCK - 1) / MOM_BLOCK), (unsigned)B);
  epistemic_moments_kernel<C><<<grid, MOM_BLOCK, 0, stream>>>(x, out, T, total);
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, MOM_MAX_C].
extern "C" int epistemic_moments_launch(const float* x, float* out, int B, int T,
                                        long long total, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(x, out, B, T, total, st); break;
    case 2: launch<2>(x, out, B, T, total, st); break;
    case 3: launch<3>(x, out, B, T, total, st); break;
    case 4: launch<4>(x, out, B, T, total, st); break;
    case 5: launch<5>(x, out, B, T, total, st); break;
    case 6: launch<6>(x, out, B, T, total, st); break;
    case 7: launch<7>(x, out, B, T, total, st); break;
    case 8: launch<8>(x, out, B, T, total, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_moments_max_classes() { return MOM_MAX_C; }
