// Tensor-core helpers shared by the port's kernels (groot_spmm.cu,
// fused_sage.cu, flash_attention.cu): the TF32 split of an f32 value, the
// warp-level mma.sync products, and the wgmma descriptor, fences and waits.
//
// mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k8 /
// m16n8k16"): lane = 4 * gid + tig.  m16n8k8 TF32: A a0 (gid, tig), a1
// (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4); B b0 (k = tig,
// n = gid), b1 (k = tig + 4, n = gid).  m16n8k16 bf16: each register holds
// two consecutive k, A a0 (gid, 2 tig..), a1 (gid + 8, 2 tig..), a2 (gid,
// 2 tig + 8..), a3 (gid + 8, 2 tig + 8..); B b0 (k = 2 tig.., n = gid), b1
// (k = 2 tig + 8.., n = gid).  C (both): c0, c1 at (gid, 2 tig + {0, 1}),
// c2, c3 at (gid + 8, 2 tig + {0, 1}).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace groot {

// f32 -> TF32 (10 explicit mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + e: hi its TF32 rounding, lo the residual (exact in f32)
// rounded to TF32, |e| <= 2^-22 |v|.  So hi + lo drops at most 2^-22 of a
// value, and hi*hi + hi*lo + lo*hi drops at most 3 * 2^-22 (1 + 2^-10) of a
// product, under 2 * 2^-21 (tests/test_torch_numerics.py).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- wgmma (warpgroup MMA) ----------------------------------------------------

// A wgmma shared-memory operand descriptor: start address, leading and stride
// byte offsets (PTX ISA, "Matrix Descriptor Format"), and the layout: 0 for no
// swizzle (8-row x 16-byte core matrices, each 128 contiguous bytes), 1 for
// the 128-byte swizzle.
constexpr uint64_t kSwizzleNone = 0, kSwizzle128 = 1;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of the warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments, which a register-sourced wgmma reads until it
// completes.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator operands of a wgmma: "+f" for d[i..i+3], d[i..i+15], ...
#define WG_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(d, i) WG_D4(d, i), WG_D4(d, i + 4), WG_D4(d, i + 8), WG_D4(d, i + 12)
#define WG_D32(d) WG_D16(d, 0), WG_D16(d, 16)
#define WG_D64(d) WG_D32(d), WG_D16(d, 32), WG_D16(d, 48)
#define WG_D128(d) WG_D64(d), WG_D16(d, 64), WG_D16(d, 80), WG_D16(d, 96), WG_D16(d, 112)

}  // namespace groot
