// Building blocks shared by the tensor-core kernels (rff_linreg_grad.cu,
// parity_encode.cu) and the staged kernels (linreg_grad.cu) on Hopper:
// cp.async copies into shared memory, ldmatrix, and float32 products on the
// tensor cores as 3xTF32.
//
// 3xTF32: each float32 operand v is split into big + small, big the TF32
// value nearest v and small the TF32 value nearest the remainder, and a
// product v*w is taken as three m16n8k8 TF32 products, small*big +
// big*small + big*big (small terms first).  That carries v*w to about 2^-22
// relative against float32's own 2^-24; single-pass TF32 (about 2^-11) is
// never used.  The tensor cores' float32 accumulate rounds toward zero, so
// the callers add their partial sums into float32 registers or shared
// memory with an ordinary float32 add every 16 K steps.
#pragma once

#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy (L2 only); zero-fills the destination where
// !valid (no byte of src is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4-byte asynchronous copy, for rows that are not 16-byte aligned;
// zero-fills where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; of 32-bit data, four 8-row x 4-column tiles:
// lanes 0-7, 8-15, 16-23, 24-31 give the row addresses of tiles 0-3, and
// lane l receives row l / 4, column l % 4 of each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one 16 x 8 x 8 TF32 tile.  Fragments (g = lane / 4,
// t4 = lane % 4): a = {(g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)},
// b = {(k = t4, n = g), (k = t4 + 4, n = g)}, c = {(g, 2 t4), (g, 2 t4 + 1),
// (g + 8, 2 t4), (g + 8, 2 t4 + 1)}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// v = big + small: big the TF32 value nearest v, small the TF32 value
// nearest the remainder (3xTF32: big*big + big*small + small*big carries
// v*w to about 2^-22 relative, float32's own rounding is 2^-24)
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(v)));
  const float rest = __uint_as_float(v) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

}  // namespace sm90
