// f32-exact products on Hopper's tensor cores: the 3xTF32 split, one
// mma.sync wrapper, and the cp.async copies that stage the operands.
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32 product
// of K >= 256 terms is off by about 1.5e-3, beyond the port's 2e-4 parity
// bound.  Each f32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (x - hi is exact in f32), rna_tf32 the rounding
// of cvt.rna.tf32.f32; the product is then
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, which leaves
// out only a_lo b_lo (about 2^-22 of |a b|) and sums like plain f32 FMAs.
// Three TF32 products per product bound the split at 495 / 3 = 165
// TFLOP/s on an H100 SXM, against 67 for f32 FMAs.
//
// Fragments follow PTX's mma.m16n8k8 .tf32 layout, with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row-major): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
//                          a[3] (g + 8, t + 4);
//   B (8 x 8, k x n):      b[0] (t, g), b[1] (t + 4, g);
//   C (16 x 8, f32):       c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
//                          c[3] (g + 8, 2t + 1).
// A kernel either loads a fragment's f32 values from shared memory and
// splits them there (split_a / split_b), or splits every staged value once
// into hi and lo planes in shared memory and loads fragments of the planes
// (ldmatrix_x4); mma_tf32x3 issues the three products.
// Only the CUDA toolkit's own headers are needed.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// The split's rounding is cvt.rna.tf32.f32's (to nearest, ties away from
// zero) for every input but a NaN, in fewer instructions: the tensor cores
// read a TF32 operand's upper 19 bits and ignore the 13 low ones, so adding
// half a TF32 ulp to the bits rounds the value as the product sees it.
// Only x - hi needs hi's low bits cleared.  cvt.rna compiles to four
// instructions on sm_90a (it also tests for NaN), most of them on the
// half-rate integer pipe, and the split runs once per operand value a
// fragment loads, so its instructions, not the products, set the pace.
constexpr uint32_t kHalfUlp = 0x1000u, kTf32Mask = 0xFFFFE000u;

// x = hi + lo + (a residual of at most 2^-22 |x|), both as the tensor
// cores read them; x - hi is exact in f32.  For finite x (a NaN stays a
// NaN in lo, and so in the product).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + kHalfUlp;
  lo = __float_as_uint(x - __uint_as_float(hi & kTf32Mask)) + kHalfUlp;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in f32 accuracy: a_lo b_hi, then a_hi b_lo, then a_hi b_hi.
// Every output element sees this one order, whatever its place in the
// fragment, so a sum over K steps is a function of K alone.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// -- cp.async: 16-byte copies global -> shared that bypass the registers --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copy 16 bytes; with in_bounds false the destination is zero-filled and
// src is not read (it must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in_bounds = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(in_bounds ? 16 : 0)
               : "memory");
}

// copy 4 bytes (both addresses 4-byte aligned), zero-filled as cp_async16:
// the route for rows whose start is not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in_bounds = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(in_bounds ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// -- fragments of split operands from shared memory -------------------------

// Four 8 x 4 tiles of 32-bit words, one register each: lane l gives the
// address of row l % 8 of tile l / 8 (16 bytes, 16-byte aligned) and gets
// word (l / 4, l % 4) of every tile, which is where mma.m16n8k8 .tf32 wants
// A's and B's operands (see the top of this file) when the tiles are
// picked as the caller's note says.  A kernel that splits its operands
// once, into hi and lo planes in shared memory, loads each fragment of a
// plane with one of these.
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(row)));
}

// -- launch ---------------------------------------------------------------

// Lets Kernel take `bytes` of dynamic shared memory and prefer the largest
// shared-memory carveout, once per device: the attributes stay set, and
// setting them again at every launch costs the host about 20 us.
template <auto Kernel>
cudaError_t set_shared_memory(int bytes) {
  static unsigned long long done = 0;  // one bit per device index < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

}  // namespace tf32x3
