// Device helpers shared by the decode kernels (epistemic_decode.cu,
// epistemic_moments.cu, epistemic_finalize.cu, box_decode.cu), so that each
// kernel evaluates the same expressions.  Compile WITHOUT --use_fast_math:
// expf/logf and the division keep their IEEE semantics, which the
// saturated-probability entropies rely on.  NaN and inf pass through as
// through the plain versions (torch.special.xlogy, torch.softmax): an
// overflowing size logit decodes to an infinite box side, a NaN class logit
// to NaN probabilities and entropies.
#pragma once

#include <math.h>

// x log x as torch.special.xlogy(p, p): exactly 0 at p == 0, NaN at NaN.
// (The JAX package's Pallas kernels take 0 wherever p > 0 fails, NaN
// included; its XLA path and the plain versions give NaN.)
__device__ __forceinline__ float xlogx(float p) {
  return p == 0.0f ? 0.0f : p * logf(p);
}

// max that passes NaN on, as torch.max does (fmaxf returns the operand that
// is not NaN)
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float logistic_entropy(float p) {
  return -(xlogx(p) + xlogx(1.0f - p));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Class logits -> softmax probabilities, in place.
template <int C>
__device__ __forceinline__ void softmax_inplace(float (&v)[C]) {
  float vmax = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) vmax = max_nan(vmax, v[c]);
  float denom = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = expf(v[c] - vmax);
    denom += v[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = v[c] / denom;
}

// Corners [y0, x0, y1, x1] of the anchor at grid cell ``cell`` (row-major in
// an h x w grid) from its localization (tx, ty, tw, th) and its prior
// (ph, pw): the cell offsets are divided by w and h (__fdiv_rn) as the plain
// version does, and the products use __fmul_rn, so no FMA contraction moves
// a rounding.
__device__ __forceinline__ void decode_corners(float tx, float ty, float tw, float th,
                                               int cell, int h, int w, float ph,
                                               float pw, float* r) {
  const float xoff = (float)(cell % w);
  const float yoff = (float)(cell / w);
  const float bx = __fdiv_rn(xoff + sigmoidf(tx), (float)w);
  const float by = __fdiv_rn(yoff + sigmoidf(ty), (float)h);
  const float w2 = __fmul_rn(__fmul_rn(expf(tw), pw), 0.5f);
  const float h2 = __fmul_rn(__fmul_rn(expf(th), ph), 0.5f);
  r[0] = by - h2;
  r[1] = bx - w2;
  r[2] = by + h2;
  r[3] = bx + w2;
}

// a * d - b * c, each product rounded on its own (no FMA), as the plain
// version computes it.
__device__ __forceinline__ float cross2(float a, float d, float b, float c) {
  return __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
}

__device__ __forceinline__ float det3(float a00, float a01, float a02,
                                      float a10, float a11, float a12,
                                      float a20, float a21, float a22) {
  const float t0 = __fmul_rn(a00, cross2(a11, a22, a12, a21));
  const float t1 = __fmul_rn(a01, cross2(a10, a22, a12, a20));
  const float t2 = __fmul_rn(a02, cross2(a10, a21, a11, a20));
  return __fadd_rn(__fsub_rn(t0, t1), t2);
}

// Determinant of a 4x4 m[i][j] by cofactor expansion along row 0, in the
// order of the plain version (ops/decode.py:_det4).
__device__ __forceinline__ float det4(const float m[4][4]) {
  const float t0 = __fmul_rn(m[0][0], det3(m[1][1], m[1][2], m[1][3],
                                           m[2][1], m[2][2], m[2][3],
                                           m[3][1], m[3][2], m[3][3]));
  const float t1 = __fmul_rn(m[0][1], det3(m[1][0], m[1][2], m[1][3],
                                           m[2][0], m[2][2], m[2][3],
                                           m[3][0], m[3][2], m[3][3]));
  const float t2 = __fmul_rn(m[0][2], det3(m[1][0], m[1][1], m[1][3],
                                           m[2][0], m[2][1], m[2][3],
                                           m[3][0], m[3][1], m[3][3]));
  const float t3 = __fmul_rn(m[0][3], det3(m[1][0], m[1][1], m[1][2],
                                           m[2][0], m[2][1], m[2][2],
                                           m[3][0], m[3][1], m[3][2]));
  return __fsub_rn(__fadd_rn(__fsub_rn(t0, t1), t2), t3);
}

// ---------------------------------------------------------------------------
// The epistemic moments of one anchor: M = 21+C sums over MC samples, in the
// row layout of bayesian_yolov3_tpu/ops/pallas_epistemic.py (:138-152):
//   [0:4)      sum loc (tx, ty, tw, th)
//   [4:14)     sum loc_i * loc_j, upper triangle in (i <= j) row-major order
//   [14:18)    sum exp(log_loc_var)
//   [18]       sum sigmoid(obj)
//   [19]       sum logistic entropy of sigmoid(obj)
//   [20:20+C)  sum softmax(cls)
//   [20+C]     sum softmax entropy
// epistemic_decode.cu sums all T samples and finalizes in one pass;
// epistemic_moments.cu sums a shard of them, and epistemic_finalize.cu
// finalizes the all-reduced sums — with these same functions.
// ---------------------------------------------------------------------------

// The 9+C channels of one sample of one anchor that the sums read, into v:
// xt points at channel 0 of the anchor's sample, channel k lies at
// xt[k * ch_stride] (loc 0-3, log_loc_var 4-7, obj 8, cls 10..10+C; the
// stddev channels are not read).  v = [loc x4 | log_loc_var x4 | obj | cls x C].
template <int C>
__device__ __forceinline__ void load_sample(const float* __restrict__ xt, size_t ch_stride,
                                            float (&v)[9 + C]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = xt[j * ch_stride];
#pragma unroll
  for (int c = 0; c < C; ++c) v[9 + c] = xt[(10 + c) * ch_stride];
}

// Adds one loaded sample v (load_sample) of one anchor to s.
template <int C>
__device__ __forceinline__ void add_sample_moments(const float (&v)[9 + C],
                                                   float (&s)[21 + C]) {
  float l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = v[j];
  float lv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) lv[j] = v[4 + j];
  const float lo = v[8];
  float p[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = v[9 + c];

#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] += l[j];
  int k = 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) s[k++] += l[i] * l[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[14 + j] += expf(lv[j]);
  const float o = sigmoidf(lo);
  s[18] += o;
  s[19] += logistic_entropy(o);
  softmax_inplace<C>(p);
  float pe = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[20 + c] += p[c];
    pe -= xlogx(p[c]);
  }
  s[20 + C] += pe;
}

// ---------------------------------------------------------------------------
// The sample split of epistemic_decode.cu and epistemic_moments.cu: which
// thread sums which samples of an anchor, and the fixed tree that combines
// the partial sums.  Both kernels reduce through reduce_anchor_samples, so
// at the same T and G they add in the same order, bit for bit: the moments
// at T_local = T, finalized, are the rows of the one-shot decode.  G is
// chosen by the wrappers (ops/cuda_epistemic.py:frame_parts) from T and
// one frame's anchor rows alone, never from the batch, the device or the
// schedule; no atomics.
//
// Block: SPLIT_WARPS warps; warp wi is part g = wi % G of anchor warp
// wi / G (G a power of two, at most SPLIT_WARPS), and lane l of anchor warp
// a holds the block's anchor 32 a + l: a warp reads 32 consecutive anchors
// of one channel and one sample (128 bytes), a block covers 256 / G anchors.
// Part g sums samples [g T / G, (g+1) T / G) in increasing t (an empty part
// when G > T), the loads of sample t+1 issued before the math of sample t.
// Combine: for d = 1, 2, 4, .., G/2, part g with g % 2d == 0 becomes
// p_g + p_{g+d}, p_{g+d} passed through one of SPLIT_WARPS / 2 slots of
// 32 x M floats in shared memory; part 0 ends with the anchor's sums.
// ---------------------------------------------------------------------------
#define SPLIT_WARPS 8
#define SPLIT_THREADS (32 * SPLIT_WARPS)
// blocks an SM holds (at most 85 registers a thread): the 360 blocks of the
// finest ECP scale at G = 1 then run in one wave on 132 SMs
#define SPLIT_MIN_BLOCKS 3

__host__ __device__ __forceinline__ bool split_parts_ok(int G) {
  return G >= 1 && G <= SPLIT_WARPS && (G & (G - 1)) == 0;
}

// The anchor (within the block) of this thread, and whether it holds part 0.
__device__ __forceinline__ int split_anchor(int G) {
  return (int)(threadIdx.x >> 5) / G * 32 + (int)(threadIdx.x & 31);
}
__device__ __forceinline__ bool split_holds_sum(int G) {
  return ((threadIdx.x >> 5) & (G - 1)) == 0;
}

// The M = 21+C moment sums of this thread's anchor over its T samples: xa
// points at channel 0, sample 0 of the anchor (sample t, channel k at
// xa[(k T + t) total]); valid is false past the ragged edge (no loads, zero
// sums).  Every thread of the block calls it (it synchronizes when G > 1).
// buf: SPLIT_THREADS / 2 * (21+C) floats of shared memory.  On return
// the threads of part 0 (split_holds_sum) hold the anchor's sums in s, and
// buf is free.
template <int C>
__device__ __forceinline__ void reduce_anchor_samples(const float* __restrict__ xa, bool valid,
                                                      int T, size_t total, int G,
                                                      float* __restrict__ buf,
                                                      float (&s)[21 + C]) {
  constexpr int M = 21 + C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp & (G - 1);
  const int a = warp / G;
#pragma unroll
  for (int k = 0; k < M; ++k) s[k] = 0.f;
  const int t0 = g * T / G;
  const int t1 = (g + 1) * T / G;
  if (valid && t0 < t1) {
    const size_t ch_stride = (size_t)T * total;
    float v[9 + C];
    load_sample<C>(xa + (size_t)t0 * total, ch_stride, v);
    for (int t = t0 + 1; t < t1; ++t) {
      float nv[9 + C];
      load_sample<C>(xa + (size_t)t * total, ch_stride, nv);  // in flight during v's math
      add_sample_moments<C>(v, s);
#pragma unroll
      for (int j = 0; j < 9 + C; ++j) v[j] = nv[j];
    }
    add_sample_moments<C>(v, s);
  }
  for (int d = 1; d < G; d *= 2) {
    // the slot of the pair (g & ~(2d-1), + d) of anchor warp a
    float* slot = buf + (size_t)(a * (G / (2 * d)) + g / (2 * d)) * (M * 32) + lane;
    if ((g & (2 * d - 1)) == d) {
#pragma unroll
      for (int k = 0; k < M; ++k) slot[k * 32] = s[k];
    }
    __syncthreads();
    if ((g & (2 * d - 1)) == 0) {
#pragma unroll
      for (int k = 0; k < M; ++k) s[k] = s[k] + slot[k * 32];
    }
    __syncthreads();
  }
}

// Moment sums over T samples -> the anchor's (21+C)-wide epistemic row r:
// [y0 x0 y1 x1 | epistemic var x4 | aleatoric var x4 | det of the epistemic
// covariance | total aleatoric var | obj mean, MI, entropy | class means x C,
// MI, entropy | layer id | prior id].  Scaled by 1/T of the GLOBAL T; each
// product and difference rounded on its own (no FMA) as the plain version.
template <int C>
__device__ __forceinline__ void finalize_row(const float (&s)[21 + C], int T, int cell,
                                             int h, int w, float ph, float pw,
                                             int layer_id, int prior, float* r) {
  const float inv_T = 1.0f / (float)T;
  float ev[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ev[j] = __fmul_rn(s[j], inv_T);
  float cov[4][4];
  int k = 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      const float cij = __fsub_rn(__fmul_rn(s[k++], inv_T), __fmul_rn(ev[i], ev[j]));
      cov[i][j] = cij;
      cov[j][i] = cij;
    }
  float ale[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ale[j] = __fmul_rn(s[14 + j], inv_T);
  const float obj_mean = __fmul_rn(s[18], inv_T);
  const float obj_post_ent = __fmul_rn(s[19], inv_T);
  const float obj_pred_ent = logistic_entropy(obj_mean);
  float cls_pred_ent = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) cls_pred_ent -= xlogx(__fmul_rn(s[20 + c], inv_T));
  const float cls_post_ent = __fmul_rn(s[20 + C], inv_T);

  decode_corners(ev[0], ev[1], ev[2], ev[3], cell, h, w, ph, pw, r);
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
  for (int c = 0; c < C; ++c) r[17 + c] = __fmul_rn(s[20 + c], inv_T);
  r[17 + C] = cls_pred_ent - cls_post_ent;
  r[18 + C] = cls_pred_ent;
  r[19 + C] = (float)layer_id;
  r[20 + C] = (float)prior;
}
