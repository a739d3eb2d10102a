// Tensor-core helpers shared by kan.cu, siren_train.cu and siren_stack.cu:
// packed bf16 planes in shared memory, ldmatrix fragments, mma.sync
// m16n8k16 (bf16 -> f32), cp.async staging, and one mma step of a bf16 tier
// (a pass per term, hi.hi apart from the cross terms), accumulated in the
// tensor core or in fresh accumulators added by f32 adds.  Internal
// linkage, as siren_common.cuh.

#pragma once

#include "siren_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b for one 16 x 8 x 16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fill the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) for `threads`
// threads, a multiple of 32
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

// bar.arrive on named barrier `id`: this thread's arrival (its prior shared
// memory writes visible to the threads that wait there), without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads));
}

// one mma step of a tier: the A operand (x role, rounded) and B (w role,
// split); hh += Ahi.Bhi, cross += Ahi.Blo (bf16x2, bf16x3) + Alo.Bhi (bf16x3)
template <int MODE>
__device__ __forceinline__ void tier_mma(float (&hh)[4], float (&cross)[4],
                                         const unsigned (&ahi)[4],
                                         const unsigned (&alo)[4],
                                         unsigned bh0, unsigned bh1,
                                         unsigned bl0, unsigned bl1) {
  mma_bf16(hh, ahi, bh0, bh1);
  if (MODE == kBf16x2 || MODE == kBf16x3) mma_bf16(cross, ahi, bl0, bl1);
  if (MODE == kBf16x3) mma_bf16(cross, alo, bh0, bh1);
}

// The cross terms of one mma step of a tier (hi.lo, and lo.hi in bf16x3),
// summed in a fresh accumulator and added to cross by an f32 add.
template <int MODE>
__device__ __forceinline__ void cross_mma(float (&cross)[4],
                                          const unsigned (&ahi)[4],
                                          const unsigned (&alo)[4],
                                          unsigned bh0, unsigned bh1,
                                          unsigned bl0, unsigned bl1) {
  if (MODE == kBf16) return;
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, ahi, bl0, bl1);
  if (MODE == kBf16x3) mma_bf16(t, alo, bh0, bh1);
#pragma unroll
  for (int q = 0; q < 4; ++q) cross[q] += t[q];
}

// One mma step of a tier, as tier_mma, but each of the step's two sums
// (hi.hi, and the cross terms) is formed in a fresh accumulator and added to
// hh / cross by an f32 add: the tensor core sums a step's products and its
// accumulator with truncation, which over a long K (every row of a slice in
// dW) drifts past an f32 chain of rounded adds.
template <int MODE>
__device__ __forceinline__ void tier_mma_f32(float (&hh)[4],
                                             float (&cross)[4],
                                             const unsigned (&ahi)[4],
                                             const unsigned (&alo)[4],
                                             unsigned bh0, unsigned bh1,
                                             unsigned bl0, unsigned bl1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, ahi, bh0, bh1);
#pragma unroll
  for (int q = 0; q < 4; ++q) hh[q] += t[q];
  cross_mma<MODE>(cross, ahi, alo, bh0, bh1, bl0, bl1);
}

__device__ __forceinline__ void split_bf16(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

}  // namespace
