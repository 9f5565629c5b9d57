// The epilogue of an int8 head conv block: int32 accumulators in, int8
// activations out — dequant, hash dropout, BN affine, LeakyReLU(0.1),
// requant — in one pass.
//
// The TPU had no Pallas kernel for it: XLA fused this epilogue into the int8
// conv of bayesian_yolov3_tpu/ops/quant.py:quant_block (:86-92).  Written as
// plain PyTorch passes it would repeat the ~14 int64 passes of a hash-dropout
// site, so the port gives it a kernel of its own.
//
// Input  acc   (M, cout) int32, row-major: the flat NHWC accumulators of S
//              samples of an NB-image batch, stacked sample-major (rows
//              [s*M/S, (s+1)*M/S) are sample s)
//        dq, bns, bnb  (cout,) f32: per-channel dequant scale, folded BN
//        inv_out       f32: inverse scale of the requantized output
//        keys  one uint32 hash key per sample (by value), or none: no dropout
// Output out   (M, cout) int8
//
// Per element, in float32 and in this order (the plain version's, and
// ops/quant.py:quant_block's of the JAX package):
//   y = float(acc) * dq[c]                    (__int2float_rn: acc > 2^24)
//   keep iff hash_keep(flat index within the sample, key) (dropout only);
//   y = keep ? y * (1/keep_prob) : 0          (PyTorch's division of a CUDA
//                                              tensor by a scalar: a multiply
//                                              by the float32 reciprocal)
//   y = y * bns[c] + bnb[c]                   (two roundings, no FMA)
//   y = y >= 0 ? y : 0.1 * y
//   q = clamp(rint(y * inv_out), -127, 127)   (half to even, as torch.round)
// Every multiply and add is an _rn intrinsic, so no FMA contraction moves a
// rounding against the plain version, which is held to it bit for bit.
//
// Bound: bytes.  Each element is read once (4 bytes) and written once (1);
// at 1024x1920 the 20 int8 head blocks hold 63.4 M elements a sample, so
// T=30 moves 9.5 GB, >= 2.8 ms at 3.35 TB/s.  The hash costs ~10 integer
// operations an element, well under the card's integer rate for that time.
// Design: a grid-stride loop, one thread on four consecutive channels of a
// row per step (cout % 4 == 0): a 16-byte load and a 4-byte store, so
// neighbouring threads touch neighbouring addresses.  Indices are 64-bit (a
// launch holds up to 921,600 x 256 elements a sample at T=30); the index
// within a sample is < 2^32, as the uint32 hash takes it.

#include <cuda_runtime.h>
#include <stdint.h>

#define QE_MAX_KEYS 64  // samples per launch; the wrapper splits larger stacks

struct QuantKeys {
  unsigned int key[QE_MAX_KEYS];
};

__device__ __forceinline__ bool hash_keep(unsigned int idx, unsigned int key,
                                          unsigned int thresh) {
  unsigned int h = idx ^ key;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h += key;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (h & 0xFFFFu) < thresh;
}

template <bool DROP>
__device__ __forceinline__ signed char epilogue(int a, float dq, float bns, float bnb,
                                                float inv_out, unsigned int idx,
                                                unsigned int key, unsigned int thresh,
                                                float inv_keep) {
  float y = __fmul_rn(__int2float_rn(a), dq);
  if (DROP) y = hash_keep(idx, key, thresh) ? __fmul_rn(y, inv_keep) : 0.0f;
  y = __fadd_rn(__fmul_rn(y, bns), bnb);
  y = y >= 0.0f ? y : __fmul_rn(y, 0.1f);
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv_out)), -127.0f), 127.0f);
  return (signed char)(int)q;
}

template <bool DROP>
__global__ void __launch_bounds__(256)
quant_epilogue_kernel(const int4* __restrict__ acc, char4* __restrict__ out,
                      const float* __restrict__ dq, const float* __restrict__ bns,
                      const float* __restrict__ bnb, float inv_out,
                      const __grid_constant__ QuantKeys keys, long long sample_elems,
                      long long n_groups, int cout, unsigned int thresh, float inv_keep) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += stride) {
    const long long e = g * 4;  // flat index of the group's first element
    const int c = (int)(e % cout);
    unsigned int key = 0, idx = 0;
    if (DROP) {
      const long long s = e / sample_elems;
      key = keys.key[s];
      idx = (unsigned int)(e - s * sample_elems);
    }
    const int4 a = acc[g];
    char4 q;
    q.x = epilogue<DROP>(a.x, __ldg(dq + c), __ldg(bns + c), __ldg(bnb + c), inv_out, idx,
                         key, thresh, inv_keep);
    q.y = epilogue<DROP>(a.y, __ldg(dq + c + 1), __ldg(bns + c + 1), __ldg(bnb + c + 1),
                         inv_out, idx + 1, key, thresh, inv_keep);
    q.z = epilogue<DROP>(a.z, __ldg(dq + c + 2), __ldg(bns + c + 2), __ldg(bnb + c + 2),
                         inv_out, idx + 2, key, thresh, inv_keep);
    q.w = epilogue<DROP>(a.w, __ldg(dq + c + 3), __ldg(bns + c + 3), __ldg(bnb + c + 3),
                         inv_out, idx + 3, key, thresh, inv_keep);
    out[g] = q;
  }
}

extern "C" {

int quant_epilogue_max_keys() { return QE_MAX_KEYS; }

// acc / out: n_elems elements, 16- and 4-byte aligned; keys: NULL for no
// dropout, else one key per sample of sample_elems elements (n_elems /
// sample_elems <= QE_MAX_KEYS).  Returns the launch's cudaError_t.
int quant_epilogue_launch(const void* acc, void* out, const float* dq, const float* bns,
                          const float* bnb, float inv_out, const QuantKeys* keys,
                          long long sample_elems, long long n_elems, int cout,
                          unsigned int thresh, float inv_keep, cudaStream_t stream) {
  const long long n_groups = n_elems / 4;
  if (n_groups == 0) return 0;
  const int threads = 256;
  const long long want = (n_groups + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);  // 32 a SM, then stride
  QuantKeys k = {};
  if (keys != nullptr) {
    k = *keys;
    quant_epilogue_kernel<true><<<blocks, threads, 0, stream>>>(
        (const int4*)acc, (char4*)out, dq, bns, bnb, inv_out, k, sample_elems, n_groups,
        cout, thresh, inv_keep);
  } else {
    quant_epilogue_kernel<false><<<blocks, threads, 0, stream>>>(
        (const int4*)acc, (char4*)out, dq, bns, bnb, inv_out, k, sample_elems, n_groups,
        cout, thresh, inv_keep);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
