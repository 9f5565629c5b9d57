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
// 11.1 MB out per image (0.051 ms at 3.35 TB/s), against about 310
// instructions per anchor-sample (the math of epistemic_decode.cu).
// Design: the samples of each anchor are split over G warps of a block and
// combined in a fixed tree by reduce_anchor_samples of decode_common.cuh,
// the function epistemic_decode.cu reduces with: at T_local = T over one
// frame both add in one order, so these sums, finalized, are the one-shot
// decode's rows bit for bit.  G (ops/cuda_epistemic.py:
// frame_parts) is 8, 4, 1 at the three ECP scales at T_local = 30 and 15;
// each lane issues the next sample's 9+C loads before this sample's math
// (see epistemic_decode.cu for the bytes in flight).  The threads of part 0
// store the M sums, neighbouring lanes on neighbouring anchors: coalesced
// without staging.  No tiling rule on total: the ragged edge is masked.
// Compile WITHOUT --use_fast_math (see decode_common.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define MOM_MAX_C 8

template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, SPLIT_MIN_BLOCKS)
epistemic_moments_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int T, long long total, int G) {
  constexpr int CHPP = 2 * (5 + C);
  constexpr int M = 21 + C;
  __shared__ float buf[SPLIT_THREADS / 2 * M];  // the combine's slots

  const int b = blockIdx.y;
  const long long a = (long long)blockIdx.x * (SPLIT_THREADS / G) + split_anchor(G);
  const bool valid = a < total;

  // channel ch, sample t of this prior: x[((b*CHPP + ch)*T + t)*total + a]
  const float* xa = x + (size_t)b * CHPP * T * total + (valid ? a : 0);
  float s[M];
  reduce_anchor_samples<C>(xa, valid, T, (size_t)total, G, buf, s);
  if (valid && split_holds_sum(G)) {
    float* ob = out + (size_t)b * M * total + a;
#pragma unroll
    for (int k = 0; k < M; ++k) ob[(size_t)k * total] = s[k];
  }
}

template <int C>
static void launch(const float* x, float* out, int B, int T, long long total, int G,
                   cudaStream_t stream) {
  const int n_rows = SPLIT_THREADS / G;
  dim3 grid((unsigned)((total + n_rows - 1) / n_rows), (unsigned)B);
  epistemic_moments_kernel<C><<<grid, SPLIT_THREADS, 0, stream>>>(x, out, T, total, G);
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, MOM_MAX_C], -2 for a part count G that is not a power of two
// in [1, SPLIT_WARPS].
extern "C" int epistemic_moments_launch(const float* x, float* out, int B, int T,
                                        long long total, int C, int G, void* stream) {
  if (!split_parts_ok(G)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(x, out, B, T, total, G, st); break;
    case 2: launch<2>(x, out, B, T, total, G, st); break;
    case 3: launch<3>(x, out, B, T, total, G, st); break;
    case 4: launch<4>(x, out, B, T, total, G, st); break;
    case 5: launch<5>(x, out, B, T, total, G, st); break;
    case 6: launch<6>(x, out, B, T, total, G, st); break;
    case 7: launch<7>(x, out, B, T, total, G, st); break;
    case 8: launch<8>(x, out, B, T, total, G, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_moments_max_classes() { return MOM_MAX_C; }

// ops/cuda_epistemic.py checks its SPLIT_WARPS against this at load
extern "C" int epistemic_moments_split_warps() { return SPLIT_WARPS; }
