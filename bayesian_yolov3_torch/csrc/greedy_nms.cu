// Greedy class-agnostic NMS: the whole selection loop in one kernel launch.
//
// Replaces the TPU kernels bayesian_yolov3_tpu/ops/pallas_nms.py:_imgvec_kernel
// (greedy_nms_pallas_imgvec) and :_kernel (greedy_nms_pallas_batched /
// greedy_nms_pallas): one function, any candidate count K.
//
// Semantics (equal to ops.nms.greedy_nms of the JAX package, index for index):
//   * each step picks the alive candidate of maximal score, ties toward the
//     LOWER index; a score of -inf is never picked, and once nothing is left
//     the loop stops (the remaining outputs keep the caller's -1 fill);
//   * then every alive candidate with IoU > thresh (strict) against the pick
//     is suppressed; IoU = inter / ((area + p_area) - inter) with areas
//     clamped at 0, so a zero-area pair gives 0/0 = NaN, which compares
//     False and stays alive.
//   Scores and coordinates must not be NaN.
//
// Bound: neither bytes nor flops but the serial chain — max_out dependent
// steps, each a block-wide argmax (two barriers, two shuffle trees) after one
// sweep over the candidates.
// Design: one thread block (1024 threads) per image; images run in parallel
// on different SMs.  Suppression against the previous pick is deferred into
// the sweep that finds the next pick, so a step traverses the candidates
// once.  A dead candidate is marked by overwriting its working score with
// -inf; each candidate is only ever touched by the one thread that owns it
// (index stride = block size), so the sweep needs no barrier of its own.
// When K*(16+4) bytes fit the block's dynamic shared memory the boxes and
// working scores live there (K = 8192: 160 KB); otherwise the same code reads
// the boxes from device memory / L2 and keeps the working scores in a scratch
// buffer the caller allocates.
// The IoU arithmetic uses the round-to-nearest intrinsics so the compiler
// cannot contract a multiply and an add into an FMA: selections must equal
// the plain version's bit for bit.  Compile WITHOUT --use_fast_math.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define NMS_THREADS 1024
#define NMS_SMEM_LIMIT (200 * 1024)

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return (s1 > s2) || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ float clamped_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(NMS_THREADS)
greedy_nms_kernel(const float4* __restrict__ boxes,  // (NB, K) [y0,x0,y1,x1]
                  const float* __restrict__ scores,  // (NB, K)
                  float* __restrict__ scratch,       // (NB, K) or unused
                  int* __restrict__ out_idx,         // (NB, max_out), -1 filled
                  int* __restrict__ out_cnt,         // (NB,)
                  int K, int max_out, float thresh, int use_smem) {
  extern __shared__ float4 dyn_smem[];
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ float win_s;
  __shared__ int win_i;

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float NEG_INF = -INFINITY;

  const float4* bx = boxes + (size_t)img * K;
  const float* sc = scores + (size_t)img * K;
  float* live;
  if (use_smem) {
    float4* sb = dyn_smem;
    live = reinterpret_cast<float*>(dyn_smem + K);
    for (int i = tid; i < K; i += blockDim.x) {
      sb[i] = bx[i];
      live[i] = sc[i];
    }
    bx = sb;
  } else {
    live = scratch + (size_t)img * K;
    for (int i = tid; i < K; i += blockDim.x) live[i] = sc[i];
  }
  __syncthreads();

  bool p_ok = false;
  int p_idx = -1;
  float4 pb = make_float4(0.f, 0.f, 0.f, 0.f);
  float p_area = 0.f;
  int cnt = 0;

  for (int t = 0; t < max_out; ++t) {
    float bs = NEG_INF;
    int bi = INT_MAX;
    for (int i = tid; i < K; i += blockDim.x) {
      const float s = live[i];
      if (s == NEG_INF) continue;  // dead, or -inf padding
      if (p_ok) {
        if (i == p_idx) {
          live[i] = NEG_INF;
          continue;
        }
        const float4 c = bx[i];
        const float iy0 = fmaxf(c.x, pb.x);
        const float ix0 = fmaxf(c.y, pb.y);
        const float iy1 = fminf(c.z, pb.z);
        const float ix1 = fminf(c.w, pb.w);
        const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                      fmaxf(__fsub_rn(ix1, ix0), 0.0f));
        const float uni = __fsub_rn(__fadd_rn(clamped_area(c), p_area), inter);
        const float iou = __fdiv_rn(inter, uni);
        if (iou > thresh) {  // NaN compares False: stays alive
          live[i] = NEG_INF;
          continue;
        }
      }
      if (s > bs) {  // i ascends within a thread: ties keep the lower index
        bs = s;
        bi = i;
      }
    }
    // block-wide lexicographic argmax (score desc, index asc)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < nwarps ? red_s[lane] : NEG_INF;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) {
        win_s = bs;
        win_i = bi;
      }
    }
    __syncthreads();
    const float ws = win_s;
    const int wi = win_i;
    if (!(ws > NEG_INF)) break;  // uniform: nothing alive is left
    if (tid == 0) out_idx[(size_t)img * max_out + t] = wi;
    ++cnt;
    p_ok = true;
    p_idx = wi;
    pb = bx[wi];
    p_area = clamped_area(pb);
  }
  if (tid == 0) out_cnt[img] = cnt;
}

// Returns the cudaError_t of the attribute call or the launch (0 = success).
// ``scratch`` may be null when K*(16+4) bytes fit NMS_SMEM_LIMIT.
extern "C" int greedy_nms_launch(const float* boxes, const float* scores,
                                 float* scratch, int* out_idx, int* out_cnt,
                                 int NB, int K, int max_out, float thresh,
                                 void* stream) {
  const size_t need = (size_t)K * (sizeof(float4) + sizeof(float));
  const int use_smem = need <= NMS_SMEM_LIMIT ? 1 : 0;
  const size_t smem = use_smem ? need : 0;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)NMS_SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<NB, NMS_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, scratch, out_idx,
      out_cnt, K, max_out, thresh, use_smem);
  return (int)cudaGetLastError();
}

extern "C" int greedy_nms_smem_limit() { return NMS_SMEM_LIMIT; }
