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

__device__ __forceinline__ float det3(float a00, float a01, float a02,
                                      float a10, float a11, float a12,
                                      float a20, float a21, float a22) {
  return a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
         a02 * (a10 * a21 - a11 * a20);
}

// cofactor expansion along row 0 of a symmetric 4x4, m[i][j]
__device__ __forceinline__ float det4(const float m[4][4]) {
  float t0 = m[0][0] * det3(m[1][1], m[1][2], m[1][3],
                            m[2][1], m[2][2], m[2][3],
                            m[3][1], m[3][2], m[3][3]);
  float t1 = m[0][1] * det3(m[1][0], m[1][2], m[1][3],
                            m[2][0], m[2][2], m[2][3],
                            m[3][0], m[3][2], m[3][3]);
  float t2 = m[0][2] * det3(m[1][0], m[1][1], m[1][3],
                            m[2][0], m[2][1], m[2][3],
                            m[3][0], m[3][1], m[3][3]);
  float t3 = m[0][3] * det3(m[1][0], m[1][1], m[1][2],
                            m[2][0], m[2][1], m[2][2],
                            m[3][0], m[3][1], m[3][2]);
  return ((t0 - t1) + t2) - t3;
}

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

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float m2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m2[i][j] = 0.f;
    float ale[4] = {0.f, 0.f, 0.f, 0.f};
    float obj_sum = 0.f, obj_ent = 0.f, cls_ent = 0.f;
    float cls_sum[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cls_sum[c] = 0.f;

    for (int t = 0; t < T; ++t) {
      const float* xt = xb + (size_t)t * total;
      float l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j] = xt[j * ch_stride];
      float lv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) lv[j] = xt[(4 + j) * ch_stride];
      const float lo = xt[8 * ch_stride];
      float lg[C];
#pragma unroll
      for (int c = 0; c < C; ++c) lg[c] = xt[(10 + c) * ch_stride];

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] += l[i];
#pragma unroll
        for (int j = i; j < 4; ++j) m2[i][j] += l[i] * l[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ale[j] += expf(lv[j]);

      const float o = sigmoidf(lo);
      obj_sum += o;
      obj_ent += logistic_entropy(o);

      float cmax = lg[0];
#pragma unroll
      for (int c = 1; c < C; ++c) cmax = fmaxf(cmax, lg[c]);
      float e[C];
      float denom = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = expf(lg[c] - cmax);
        denom += e[c];
      }
      float pe = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = e[c] / denom;
        cls_sum[c] += p;
        pe -= xlogx(p);
      }
      cls_ent += pe;
    }

    const float inv_T = 1.0f / (float)T;
    float ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ev[i] = s[i] * inv_T;
    float cov[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = i; j < 4; ++j) {
        const float cij = m2[i][j] * inv_T - ev[i] * ev[j];
        cov[i][j] = cij;
        cov[j][i] = cij;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) ale[j] *= inv_T;

    const float obj_mean = obj_sum * inv_T;
    const float obj_post_ent = obj_ent * inv_T;
    const float obj_pred_ent = logistic_entropy(obj_mean);

    float cls_pred_ent = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cls_sum[c] *= inv_T;
      cls_pred_ent -= xlogx(cls_sum[c]);
    }
    const float cls_post_ent = cls_ent * inv_T;

    // corner decode on the mean localization
    const long long cell = a % hw;
    const float xoff = (float)(cell % w);
    const float yoff = (float)(cell / w);
    const float ph = pri[2 * b + 0];
    const float pw = pri[2 * b + 1];
    const float bx = (xoff + sigmoidf(ev[0])) * (1.0f / (float)w);
    const float by = (yoff + sigmoidf(ev[1])) * (1.0f / (float)h);
    const float w2 = expf(ev[2]) * pw * 0.5f;
    const float h2 = expf(ev[3]) * ph * 0.5f;

    float* r = tile + threadIdx.x * W;
    r[0] = by - h2;
    r[1] = bx - w2;
    r[2] = by + h2;
    r[3] = bx + w2;
#pragma unroll
    for (int j = 0; j < 4; ++j) r[4 + j] = cov[j][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[8 + j] = ale[j];
    r[12] = det4(cov);
    r[13] = ((ale[0] + ale[1]) + ale[2]) + ale[3];
    r[14] = obj_mean;
    r[15] = obj_pred_ent - obj_post_ent;
    r[16] = obj_pred_ent;
#pragma unroll
    for (int c = 0; c < C; ++c) r[17 + c] = cls_sum[c];
    r[17 + C] = cls_pred_ent - cls_post_ent;
    r[18 + C] = cls_pred_ent;
    r[19 + C] = (float)layer_id;
    r[20 + C] = (float)b;
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
