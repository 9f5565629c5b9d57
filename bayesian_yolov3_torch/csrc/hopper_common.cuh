// The Hopper pieces shared by the three fused conv kernels (fused_stem.cu,
// fused_res_block.cu, fused_downsample.cu): 128-byte-swizzled shared memory,
// cp.async with zero fill, bulk copies completing on mbarriers, wgmma from
// shared-memory descriptors, and the register epilogue's quad transpose.
//
// Every operand tile in shared memory is a run of 128-byte rows (64 bf16
// channels or K values), its 16-byte chunks XOR-swizzled by address bits 7-9:
// the SWIZZLE_128B layout that a wgmma descriptor reads.  The swizzle follows
// the shared address, so a region starts at a multiple of 1024 bytes and a
// descriptor may start at any row of it (base offset 0; measured on the H100
// for starts 0, 1, 5, 8, 13, 64).  A K-major operand of 16 K values is the
// run's rows at a byte offset of 32 * k within each row.
//
// wgmma accumulator layout (m64nN, f32): thread (warp w4 of its warpgroup,
// g = lane / 4, q = lane % 4) holds, for each n8 tile t, d[4t], d[4t+1] =
// row 16*w4 + g, columns 8t + 2q, +1, and d[4t+2], d[4t+3] = the same
// columns of row 16*w4 + g + 8.

#pragma once

#include "conv_common.cuh"

namespace fconv {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 128-byte swizzle: the 16-byte chunk bits 4-6 of a shared address XORed
// with its bits 7-9, as wgmma reads a SWIZZLE_128B operand
__device__ __forceinline__ uint32_t swz(uint32_t addr) {
  return addr ^ (((addr >> 7) & 7u) << 4);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, bulk copies); then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major operand, 128-byte rows, 128-byte swizzle, 8-row groups 1024 bytes
// apart, base offset 0
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of the barrier's phase, which then waits for `bytes`
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// a bulk copy of `bytes` (a multiple of 16, 16-byte aligned on both sides)
// into shared memory, counted against `bar`'s expected bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one bulk copy completing `bar`'s phase
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// a 4-D tensor-map copy (TMA) of the box at coordinates (c0 .. c3), innermost
// first, into shared memory, counted against `bar`; out-of-bounds elements
// (negative coordinates included) are filled with zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a 16-byte global load issued where it stands (volatile: the compiler keeps
// it ahead of the products it is meant to overlap)
__device__ __forceinline__ uint4 ld_early16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// 8 bytes global -> shared without registers; `valid` false fills zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// A copy that never lands would spin the block forever: after about a second
// of waiting the kernel traps, so the launch fails with an error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// D (+)= A * B over 16 K values, A and B K-major in swizzled shared memory;
// `acc` = 0 ignores D's old contents (the first product of a sum)
__device__ __forceinline__ void wgmma_m64n16k16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 16) wgmma_m64n16k16(d, da, db, acc);
  if constexpr (N == 32) wgmma_m64n32k16(d, da, db, acc);
  if constexpr (N == 64) wgmma_m64n64k16(d, da, db, acc);
  if constexpr (N == 128) wgmma_m64n128k16(d, da, db, acc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending;
// then acc_fence each accumulator that is read or written next
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The register epilogue's 4x4 transpose inside each quad of lanes: lane q
// passes m[t], its word of n8 tile t (t = 0..3: columns 8t + 2q, +1 of its
// row), and gets back in m[p] the word lane p held for tile q, i.e. columns
// 8q + 2p, +1: eight consecutive columns of one row per lane.  Two rounds of
// XOR shuffles, each swapping one bit of (lane, index); selects on the lane's
// bits, no runtime-indexed array (which compiled to branches).
__device__ __forceinline__ void quad_transpose(uint32_t* m, int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  uint32_t s0 = b0 ? m[0] : m[1], s1 = b0 ? m[2] : m[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  m[0] = b0 ? s0 : m[0];
  m[1] = b0 ? m[1] : s0;
  m[2] = b0 ? s1 : m[2];
  m[3] = b0 ? m[3] : s1;
  s0 = b1 ? m[0] : m[2];
  s1 = b1 ? m[1] : m[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  m[0] = b1 ? s0 : m[0];
  m[2] = b1 ? m[2] : s0;
  m[1] = b1 ? s1 : m[1];
  m[3] = b1 ? m[3] : s1;
}

// Dynamic shared memory above 48 KB has to be asked for: once per kernel and
// device (`done` is the caller's static flag array), not on every launch.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t request_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Persistent blocks: one per SM (`per_sm` where that many fit), at most one
// per tile; the SM count is read once per device.
inline int persistent_blocks(long long tiles, int per_sm) {
  static int sms[kMaxDevices] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices) n = sms[dev];
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 1;
    if (dev < kMaxDevices) sms[dev] = n;
  }
  const long long b = (long long)n * per_sm;
  return (int)(tiles < b ? tiles : b);
}

}  // namespace fconv

// Phase counters, compiled in only with -DFCONV_PHASES (a measurement build,
// ops/_build.py:load(name, defines=...)): thread 0 of every block adds the
// clock cycles between consecutive PHASE_MARK(i) to counter i, and
// fconv_phases_read copies the sums out and zeroes them.
#ifdef FCONV_PHASES
constexpr int kPhases = 8;
static __device__ unsigned long long fconv_phase_cycles[kPhases];
#define PHASE_START()                                \
  long long phase_last = clock64(), phase_acc[kPhases]; \
  for (int i = 0; i < kPhases; ++i) phase_acc[i] = 0
#define PHASE_MARK(i)                                   \
  do {                                                  \
    if (threadIdx.x == 0) {                             \
      const long long now = clock64();                  \
      phase_acc[i] += now - phase_last;                 \
      phase_last = now;                                 \
    }                                                   \
  } while (0)
#define PHASE_FLUSH()                                                          \
  do {                                                                         \
    if (threadIdx.x == 0)                                                      \
      for (int i = 0; i < kPhases; ++i)                                        \
        atomicAdd(&fconv_phase_cycles[i], (unsigned long long)phase_acc[i]);   \
  } while (0)
extern "C" int fconv_phases_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, fconv_phase_cycles, sizeof(fconv_phase_cycles));
  const unsigned long long zero[kPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fconv_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#else
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#define PHASE_FLUSH() \
  do {                \
  } while (0)
#endif
