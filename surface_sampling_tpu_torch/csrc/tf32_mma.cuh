// Tensor-core and copy primitives shared by the kernels that run their
// radial products as mma.sync tiles: painn_message_bwd.cuh (rows 4 and 9),
// painn_message_banded.cuh (rows 2, 7 and 8), painn_message_bwd2.cu (row 5)
// and chgnet_conv.cuh (rows 10-12).
//
// f32 accuracy on TF32 tensor cores (3xTF32): each operand x = hi + lo with
// both parts TF32, |x - hi - lo| <= 2^-20 |x|, and a.b ~ a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi. A single TF32 pass (about 3 decimal digits) is
// never used.

#pragma once

#include <cuda_runtime.h>

namespace tf32mma {

constexpr unsigned FULL = 0xffffffffu;

// x = hi + lo with both parts TF32 (10 explicit mantissa bits): hi keeps
// x's top bits, lo = x - hi is exact in f32 and is cut to TF32 in turn, so
// |x - hi - lo| <= 2^-20 |x|. Masks and one subtraction: the conversion
// instruction (cvt.rna.tf32.f32) issues at a fraction of the ALU rate.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a . b, one m16n8k8 TF32 tile (a 16 x 8 row-major, b 8 x 8 column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in f32 accuracy: the two cross terms, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

template <int N>
__device__ __forceinline__ void split_all(const float (&x)[N], unsigned (&hi)[N],
                                          unsigned (&lo)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) split(x[q], hi[q], lo[q]);
}

// 16 bytes global -> shared, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronous (no alignment beyond the float's).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Sum over the four threads of a quad (lanes 4g .. 4g + 3), the same
// value in all four: (v0 + v1) + (v2 + v3) in every lane.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

}  // namespace tf32mma
