// Greedy class-agnostic NMS as a sorted bitmask scan, chunk by chunk.
//
// Replaces the TPU kernels bayesian_yolov3_tpu/ops/pallas_nms.py:_imgvec_kernel
// (greedy_nms_pallas_imgvec) and :_kernel (greedy_nms_pallas_batched /
// greedy_nms_pallas): one function, any candidate count K, NB images.
//
// Semantics (equal to ops.nms.greedy_nms of the JAX package, index for index):
// each step picks the alive candidate of maximal score, ties toward the LOWER
// index; a score of -inf is never picked; every alive candidate with IoU >
// thresh (strict) against the pick is suppressed; IoU = inter / ((area_c +
// area_p) - inter) with areas clamped at 0, so a zero-area pair gives NaN,
// which compares False and keeps the candidate.  At most max_out picks, in
// selection order.  NaN passes through the IoU as through the plain version's
// torch.maximum / torch.minimum / clamp (and jnp.maximum / jnp.minimum of the
// JAX package): a NaN corner makes every IoU with its box NaN, so that box
// suppresses nothing and nothing suppresses it.  A NaN score sorts first and
// ends the scan (the plain loop's max is NaN there): no pick.
//
// Formulation.  The wrapper sorts the candidates by (score desc, index asc)
// (ops/cuda_nms.py).  Greedy argmax is then a scan in that order: a candidate
// is kept iff no box kept before it suppresses it.  The scan walks chunks of
// NMS_CHUNK sorted candidates; per chunk three kernels run:
//   presuppress  (many blocks)  marks each chunk candidate suppressed by any
//                box kept in an earlier chunk (at most max_out of them);
//   mask         (many blocks)  the chunk's upper-triangular IoU > thresh
//                bitmask, NMS_CHUNK x NMS_CHUNK/64 words of 64 bits, rows of
//                suppressed candidates skipped (the scan never reads them);
//   scan         (one warp per image)  walks the chunk in order, 64
//                candidates a word: alive = live & ~(removed | presuppressed),
//                live = the candidates before the first invalid one;
//                the first alive one is kept and its row's bits in this word
//                clear the candidates it suppresses; after the word, the kept
//                rows' later words are ORed into `removed`.  It stops at
//                max_out picks or at the first -inf or NaN score.
// A per-image done flag in device memory makes every later kernel of that
// image return at once, so the host enqueues all chunks without a sync.
//
// Bound: the operations are picks x K IoUs at most; what limits the old
// one-block loop (max_out dependent block-wide argmax sweeps on one SM) is
// gone: the IoU work spreads over all SMs, and the serial part is one warp
// doing a bit scan plus one L2 read of a mask row per kept box.
// Exactness: the IoU is the plain version's expression with round-to-nearest
// intrinsics (no FMA contraction); max_nan / min_nan / fadd are commutative
// up to the sign of a zero and the payload of a NaN, neither of which moves
// a comparison, so the (row, column) IoU compares as the (pick, candidate)
// IoU of the plain loop.  (fmaxf / fminf return the operand that is not NaN:
// with a NaN corner they gave a finite IoU where the plain version's is NaN,
// and another pick.)  Compile WITHOUT --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NMS_CHUNK 4096                   // sorted candidates per chunk
#define NMS_WORDS (NMS_CHUNK / 64)       // 64-bit mask words per row
#define NMS_PRE_WORDS (NMS_CHUNK / 32)   // 32-bit presuppression words

typedef unsigned long long u64;

// max and min that pass NaN on, as torch.maximum / torch.minimum do
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float clamped_area(const float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f), max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(const float4 a, float area_a, const float4 b,
                                     float area_b) {
  const float iy0 = max_nan(a.x, b.x), ix0 = max_nan(a.y, b.y);
  const float iy1 = min_nan(a.z, b.z), ix1 = min_nan(a.w, b.w);
  const float inter = __fmul_rn(max_nan(__fsub_rn(iy1, iy0), 0.0f),
                                max_nan(__fsub_rn(ix1, ix0), 0.0f));
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// grid (words of the chunk, NB), 64 threads: one candidate each.
__global__ void __launch_bounds__(64)
nms_presuppress(const float4* __restrict__ sboxes, const float4* __restrict__ kept,
                const int* __restrict__ cnt, const int* __restrict__ done,
                uint32_t* __restrict__ pre, int K, int max_out, int c0, float thresh) {
  const int img = blockIdx.y, tid = threadIdx.x;
  if (done[img]) return;
  __shared__ float4 kb[64];
  __shared__ float ka[64];
  const int n_kept = cnt[img];
  const int i = c0 + blockIdx.x * 64 + tid;
  bool sup = i >= K;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  float a = 0.f;
  if (!sup) {
    b = sboxes[(size_t)img * K + i];
    a = clamped_area(b);
  }
  for (int k0 = 0; k0 < n_kept; k0 += 64) {
    if (!__syncthreads_or(!sup)) break;  // all 64 suppressed: nothing to add
    if (k0 + tid < n_kept) {
      kb[tid] = kept[(size_t)img * max_out + k0 + tid];
      ka[tid] = clamped_area(kb[tid]);
    }
    __syncthreads();
    const int kn = min(64, n_kept - k0);
    for (int j = 0; j < kn && !sup; ++j) sup = iou(b, a, kb[j], ka[j]) > thresh;
  }
  const uint32_t word = __ballot_sync(0xffffffffu, sup);
  if ((tid & 31) == 0) pre[(size_t)img * NMS_PRE_WORDS + blockIdx.x * 2 + (tid >> 5)] = word;
}

// grid (column tile, row tile, NB), 64 threads: thread t computes the bits of
// chunk row rt*64 + t against the 64 candidates of column tile ct >= rt.
__global__ void __launch_bounds__(64)
nms_mask(const float4* __restrict__ sboxes, const uint32_t* __restrict__ pre,
         const int* __restrict__ done, u64* __restrict__ mask, int K, int c0,
         float thresh) {
  const int ct = blockIdx.x, rt = blockIdx.y, img = blockIdx.z, tid = threadIdx.x;
  if (ct < rt || done[img]) return;
  const uint32_t* pw = pre + (size_t)img * NMS_PRE_WORDS + rt * 2;
  const uint32_t p0 = pw[0], p1 = pw[1];
  if ((p0 & p1) == 0xffffffffu) return;  // every row of the tile is suppressed
  __shared__ float4 cb[64];
  __shared__ float ca[64];
  const int j0 = c0 + ct * 64;
  if (j0 + tid < K) {
    cb[tid] = sboxes[(size_t)img * K + j0 + tid];
    ca[tid] = clamped_area(cb[tid]);
  }
  __syncthreads();
  const int il = rt * 64 + tid, i = c0 + il;
  if (i >= K || (((tid < 32 ? p0 : p1) >> (tid & 31)) & 1u)) return;
  const float4 b = sboxes[(size_t)img * K + i];
  const float a = clamped_area(b);
  const int jn = min(64, K - j0);
  u64 bits = 0ull;
  for (int j = ct == rt ? tid + 1 : 0; j < jn; ++j)
    if (iou(b, a, cb[j], ca[j]) > thresh) bits |= 1ull << j;
  mask[((size_t)img * NMS_CHUNK + il) * NMS_WORDS + ct] = bits;
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
  return ((u64)hi << 32) | lo;
}

// grid (NB), one warp: the serial scan of one chunk of one image, 64
// candidates (one mask word g) at a time.  Lane l holds words l and l + 32 of
// `removed` and the diagonal words (row 64g+l and 64g+32+l, word g) of the
// mask: the in-word scan is shuffles and bit operations only; the kept rows'
// later words are ORed into `removed` after the word, their loads in flight
// together, and the picks are written out then.
__global__ void __launch_bounds__(32)
nms_scan(const float4* __restrict__ sboxes, const float* __restrict__ sscores,
         const int64_t* __restrict__ order, const uint32_t* __restrict__ pre,
         const u64* __restrict__ mask, float4* __restrict__ kept,
         int* __restrict__ out_idx, int* __restrict__ cnt, int* __restrict__ done,
         int K, int max_out, int c0) {
  const int img = blockIdx.x, lane = threadIdx.x;
  if (done[img]) return;
  __shared__ int picked[64];
  const int len = min(NMS_CHUNK, K - c0), nw = (len + 63) / 64;
  const float* sc = sscores + (size_t)img * K + c0;
  const uint32_t* pw = pre + (size_t)img * NMS_PRE_WORDS;
  const u64* rows = mask + (size_t)img * NMS_CHUNK * NMS_WORDS;
  u64 rem_lo = 0ull, rem_hi = 0ull;  // removed words lane, lane + 32
  int count = cnt[img];
  bool finished = false;
  for (int g = 0; g < nw && !finished; ++g) {
    const int q0 = 64 * g + lane, q1 = q0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, q0 < len && sc[q0] > -INFINITY);
    const uint32_t hi = __ballot_sync(0xffffffffu, q1 < len && sc[q1] > -INFINITY);
    const u64 valid = ((u64)hi << 32) | lo;
    // the scan ends at the first candidate that is not valid: past K, a -inf
    // score (sorted last), or a NaN score (sorted first: no pick, as the
    // plain loop, whose max is then NaN); only the candidates before it live
    const u64 invalid = ~valid;
    const u64 live = invalid ? (invalid & (0ull - invalid)) - 1ull : ~0ull;
    const u64 presup = ((u64)pw[2 * g + 1] << 32) | pw[2 * g];
    // diagonal words; rows never computed (suppressed, past K) are never used
    const u64 diag_lo = rows[(size_t)q0 * NMS_WORDS + g];
    const u64 diag_hi = rows[(size_t)q1 * NMS_WORDS + g];
    u64 cand = live & ~(shfl64(g < 32 ? rem_lo : rem_hi, g & 31) | presup);
    u64 keep = 0ull;
    const int before = count;
    while (cand) {
      const int i = __ffsll((long long)cand) - 1;
      keep |= 1ull << i;
      if (++count == max_out) {
        finished = true;
        break;
      }
      cand &= ~shfl64(i < 32 ? diag_lo : diag_hi, i & 31);
      cand &= i == 63 ? 0ull : (~0ull << (i + 1));
    }
    if (valid != ~0ull) finished = true;  // the sorted scores reached -inf or K
    if (!keep) continue;
    // the picks of this word, in order: output and kept boxes, one per lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if ((keep >> j) & 1ull) {
        const int r = before + __popcll(keep & ((1ull << j) - 1ull));
        const int pos = c0 + 64 * g + j;
        out_idx[(size_t)img * max_out + r] = (int)order[(size_t)img * K + pos];
        kept[(size_t)img * max_out + r] = sboxes[(size_t)img * K + pos];
        picked[r - before] = j;
      }
    }
    __syncwarp();
    if (finished || g + 1 == nw) continue;
    // later words of the kept rows into `removed`, 8 row loads in flight
    const int nk = count - before;
    for (int r0 = 0; r0 < nk; r0 += 8) {
      u64 v_lo[8], v_hi[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const u64* row = rows + (size_t)(64 * g + picked[min(r0 + u, nk - 1)]) * NMS_WORDS;
        v_lo[u] = lane > g && lane < nw ? row[lane] : 0ull;
        v_hi[u] = lane + 32 > g && lane + 32 < nw ? row[lane + 32] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) rem_lo |= v_lo[u], rem_hi |= v_hi[u];
    }
    __syncwarp();  // `picked` is rewritten by the next word
  }
  if (lane == 0) {
    cnt[img] = count;
    if (finished) done[img] = 1;
  }
}

namespace {
size_t mask_bytes(int NB) { return (size_t)NB * NMS_CHUNK * NMS_WORDS * sizeof(u64); }
size_t pre_bytes(int NB) { return (size_t)NB * NMS_PRE_WORDS * sizeof(uint32_t); }
size_t kept_bytes(int NB, int max_out) { return (size_t)NB * max_out * sizeof(float4); }
}  // namespace

// Scratch the caller allocates (16-byte aligned) for NB images.
extern "C" size_t greedy_nms_scratch_bytes(int NB, int max_out) {
  return mask_bytes(NB) + pre_bytes(NB) + kept_bytes(NB, max_out) + (size_t)NB * sizeof(int);
}

extern "C" int greedy_nms_chunk() { return NMS_CHUNK; }

// sboxes (NB, K, 4), sscores (NB, K): the candidates in (score desc, index asc)
// order; order (NB, K) int64: their original indices.  out_idx (NB, max_out)
// int32 filled with -1 by the caller; out_cnt (NB,) int32.  Returns the first
// cudaError_t of the enqueued work (0 = success).  NB <= 65535.
extern "C" int greedy_nms_launch(const float* sboxes, const float* sscores,
                                 const int64_t* order, int* out_idx, int* out_cnt,
                                 void* scratch, int NB, int K, int max_out,
                                 float thresh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* s = (unsigned char*)scratch;
  u64* mask = (u64*)s;
  uint32_t* pre = (uint32_t*)(s + mask_bytes(NB));
  float4* kept = (float4*)(s + mask_bytes(NB) + pre_bytes(NB));
  int* done = (int*)(s + mask_bytes(NB) + pre_bytes(NB) + kept_bytes(NB, max_out));
  const float4* bx = (const float4*)sboxes;
  cudaError_t err = cudaMemsetAsync(out_cnt, 0, (size_t)NB * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(done, 0, (size_t)NB * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(pre, 0, pre_bytes(NB), st);
  if (err != cudaSuccess) return (int)err;
  for (int c0 = 0; c0 < K; c0 += NMS_CHUNK) {
    const int len = K - c0 < NMS_CHUNK ? K - c0 : NMS_CHUNK;
    const int nw = (len + 63) / 64;
    if (c0)  // chunk 0 has no earlier picks: its words stay 0 from the memset
      nms_presuppress<<<dim3(nw, NB), 64, 0, st>>>(bx, kept, out_cnt, done, pre, K, max_out,
                                                   c0, thresh);
    nms_mask<<<dim3(nw, nw, NB), 64, 0, st>>>(bx, pre, done, mask, K, c0, thresh);
    nms_scan<<<NB, 32, 0, st>>>(bx, sscores, order, pre, mask, kept, out_idx, out_cnt, done,
                                K, max_out, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
