// Hopper building blocks shared by the port's kernels: asynchronous
// global -> shared copies (cp.async, sm_80 and later) and the bf16
// tensor-core product mma.sync.m16n8k16 with fp32 accumulators.
#pragma once
#include <stdint.h>

namespace hk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// as cp_async16, but only src_bytes (0..16) are read and the rest of the
// 16 bytes is zero-filled; with 0 nothing is read
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared, src_bytes of them read and the rest zero-filled
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory: lanes 8i .. 8i+7 give the
// 16-byte row addresses of matrix i; lane l receives in r[i] the two
// elements (l / 4, 2 (l % 4) .. +1) of matrix i (an mma fragment)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// 2^x with the hardware approximation (ex2.approx.ftz: 2 ulp, subnormal
// results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), fp32 d.
// Fragments (g = lane / 4, t = lane % 4): a[0] = A[g][2t..2t+1],
// a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..];
// b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; d[0..1] = D[g][2t..2t+1],
// d[2..3] = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace hk
