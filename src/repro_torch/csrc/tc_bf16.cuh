// Warp-level bf16 tensor-core building blocks for Hopper (sm_90a), shared
// by the bf16 paths of flash_attention.cu and moe_gmm.cu:
//
//   cp.async 16-byte global -> shared copies (zero-filled past an edge),
//   committed in groups and waited for with cp.async.wait_group;
//   ldmatrix.x4 / .x2 (and .trans) from shared memory into mma fragments;
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4; a register
// holds two bf16, the lower column in its low half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
//     2t+8..), a3 (g+8, 2t+8..);
//   B (16 x 8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8, f32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// ldmatrix hands lane l row l / 4, columns 2 (l % 4) .. + 1 of each 8 x 8
// matrix (with .trans: rows 2 (l % 4) .. + 1, column l / 4), so an 8 x 8
// block stored k-contiguous is a B fragment as it is, and one stored
// n-contiguous (V, a weight (D, F)) is one through .trans.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ``pred`` false nothing is read (``src``
// must still be a valid address) and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two matrices: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b on one m16n8k16 tile, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of bf16x2 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace tc
