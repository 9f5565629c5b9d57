// Epistemic statistics + bbox decode in one pass over the raw MC-sample heads.
//
// Replaces the TPU kernel bayesian_yolov3_tpu/ops/pallas_epistemic.py:_kernel
// (behind fused_epistemic_decode_cf_batched / fused_epistemic_decode_cf).
//
// Input  x    (B*chpp, T, total) f32, total = n_imgs*h*w, anchors minor
//        pri  (B, 2) f32 (prior_h, prior_w)
// Output out  (n_imgs, B*h*w, 21+C) f32, rows prior-major then row-major cells.
//
// Bound: bytes.  The kernel reads the 9+C channels the function uses (loc,
// log_loc_var, obj, cls; not the stddev channels) of every sample once and
// writes the rows: at 1024x1920, T=30, C=2, 159.7 MB in and 11.1 MB out per
// image, 0.051 ms at 3.35 TB/s.  Issue is of the same order: about 310
// instructions per anchor-sample in the SASS (7 expf, 4 logf, 3 IEEE
// divisions at C=2, no fast math), 3.6 M anchor-samples an image.
// Design: each anchor's samples are split over G warps of a block and their
// partial sums combined in a fixed tree (reduce_anchor_samples of
// decode_common.cuh, which epistemic_moments.cu shares, so the split form
// at T_local = T gives these rows bit for bit).  G (ops/cuda_epistemic.py:
// frame_parts, from one image's anchor rows) fills the card at the coarse scales: at T=30 the three ECP
// scales take G = 8, 4, 1, grids of 1440, 2880 and 2880 warps.  A warp reads
// 32 consecutive anchors of one channel and one sample, coalesced, and
// issues the next sample's 9+C loads before this sample's math: at the
// finest scale 21.8 warps an SM keep 30.7 KB in flight at C=2, against the
// 8.8 KB an SM that Little's law asks for (3.35 TB/s x 346 ns, the unloaded
// latency of one load from device memory that measure_latency.py reads by a
// pointer chase on an NVIDIA H100 80GB HBM3 at 700 W).
// One thread of each anchor (part 0) finalizes its row into shared memory
// (odd row pitch); the block writes its rows back as contiguous runs.  No
// tiling rule on total: the ragged edge is masked, and with n_imgs > 1 a
// block may cross image boundaries (one run per image it touches).
// Compile WITHOUT --use_fast_math: expf/logf/division semantics matter for
// the saturated-probability entropies.

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

#define EPI_MAX_C 8

template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, SPLIT_MIN_BLOCKS)
epistemic_decode_kernel(const float* __restrict__ x,
                        const float* __restrict__ pri,
                        float* __restrict__ out,
                        int B, int T, int n_imgs, int h, int w, int layer_id, int G) {
  constexpr int CHPP = 2 * (5 + C);
  constexpr int W = 21 + C;
  constexpr int PITCH = W | 1;  // odd row pitch: no bank conflicts
  // the combine's slots, then the block's rows
  __shared__ float buf[SPLIT_THREADS * PITCH];

  const long long hw = (long long)h * w;
  const long long total = (long long)n_imgs * hw;
  const int b = blockIdx.y;
  const int n_rows = SPLIT_THREADS / G;
  const int row = split_anchor(G);
  const long long a0 = (long long)blockIdx.x * n_rows;
  const long long a = a0 + row;
  const bool valid = a < total;

  // channel ch, sample t of this prior: x[((b*CHPP + ch)*T + t)*total + a]
  const float* xa = x + (size_t)b * CHPP * T * total + (valid ? a : 0);
  float s[W];
  reduce_anchor_samples<C>(xa, valid, T, (size_t)total, G, buf, s);
  if (valid && split_holds_sum(G))
    finalize_row<C>(s, T, (int)(a % hw), h, w, pri[2 * b + 0], pri[2 * b + 1],
                    layer_id, b, buf + row * PITCH);
  __syncthreads();

  // coalesced write-back: the block's rows are one contiguous run of output
  // rows in each image they touch; consecutive threads write consecutive
  // addresses of a run (no division by the image size per element)
  const int n_valid = (int)(total - a0 < n_rows ? total - a0 : n_rows);
  long long img = a0 / hw;
  long long cell = a0 - img * hw;
  for (int r0 = 0; r0 < n_valid; ++img, cell = 0) {
    const int run = (int)(hw - cell < n_valid - r0 ? hw - cell : n_valid - r0);
    float* o = out + (((size_t)img * B + b) * hw + cell) * W;
    for (int i = threadIdx.x; i < run * W; i += blockDim.x) {
      const int r = i / W;
      o[i] = buf[(r0 + r) * PITCH + (i - r * W)];
    }
    r0 += run;
  }
}

template <int C>
static void launch(const float* x, const float* pri, float* out, int B, int T,
                   int n_imgs, int h, int w, int layer_id, int G, cudaStream_t stream) {
  const long long total = (long long)n_imgs * h * w;
  const int n_rows = SPLIT_THREADS / G;
  dim3 grid((unsigned)((total + n_rows - 1) / n_rows), (unsigned)B);
  epistemic_decode_kernel<C><<<grid, SPLIT_THREADS, 0, stream>>>(
      x, pri, out, B, T, n_imgs, h, w, layer_id, G);
}

// Returns the cudaError_t of the launch (0 = success); -1 for a class count
// outside [1, EPI_MAX_C], -2 for a part count G that is not a power of two
// in [1, SPLIT_WARPS].
extern "C" int epistemic_decode_launch(const float* x, const float* pri,
                                       float* out, int B, int T, int n_imgs,
                                       int h, int w, int C, int layer_id, int G,
                                       void* stream) {
  if (!split_parts_ok(G)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 2: launch<2>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 3: launch<3>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 4: launch<4>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 5: launch<5>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 6: launch<6>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 7: launch<7>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    case 8: launch<8>(x, pri, out, B, T, n_imgs, h, w, layer_id, G, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int epistemic_decode_max_classes() { return EPI_MAX_C; }

// ops/cuda_epistemic.py checks its SPLIT_WARPS against this at load
extern "C" int epistemic_decode_split_warps() { return SPLIT_WARPS; }
