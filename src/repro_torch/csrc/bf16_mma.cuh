// The bf16 tensor-core machinery of the bf16 attention kernels
// (flash_attention_bf16.cu, the forward pair; flash_attention_bwd_bf16.cu,
// the backward pair): blocks of 4 warps, bf16 rows staged in shared memory by
// 16-byte cp.async copies with their chunks XOR-swizzled by row, fragments
// loaded with ldmatrix (plain and .trans), one mma.sync m16n8k16 bf16
// product with f32 accumulation (each bf16 x bf16 product exact in f32), and
// the split of an f32 accumulator tile into PIECES bf16 A fragments, which
// carries an f32 intermediate (P, dS) into the next product.
//
// Rows are D bf16 values, unpadded, in C = D / 8 chunks of 16 bytes; chunk
// c of row r lies at c ^ (r & 7) from D = 64 up, c ^ ((r / (8 / C)) % C)
// below, which keeps the 8 rows of every ldmatrix, plain and transposed, in
// distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tf32x3.cuh"

namespace bf16_mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int PIECES = 2;  // bf16 pieces of an f32 A operand (P, dS)

// where chunk c (8 values) of staged row r starts, in values (see the top
// of this file)
template <int C>
__device__ __forceinline__ int chunk(int r, int c) {
  if constexpr (C >= 8)
    return (r * C + (c ^ (r & 7))) * 8;
  else
    return (r * C + (c ^ ((r / (8 / C)) % C))) * 8;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ __nv_bfloat162 pair(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(u));
  return h;
}

// 8 bf16 values times scale, each rounded once to bf16: q^ = bf16(q s)
__device__ __forceinline__ uint4 scaled(uint4 u, float scale) {
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pair(w[i]));
    w[i] = bits(__floats2bfloat162_rn(f.x * scale, f.y * scale));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Four 8 x 8 matrices of 16-bit values, one register each: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes) and gets elements (l / 4,
// 2 (l % 4) + {0, 1}) of each, or with .trans (2 (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tf32x3::smem_addr(row)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tf32x3::smem_addr(row)));
}

// the same from a shared-memory address (a kernel that keeps its lanes'
// offsets into a tile adds them to the tile's address)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, one m16n8k16 bf16 product with f32 accumulation.  With g =
// lane / 4, t = lane % 4: A (16 x 16) a[0] (g, 2t..2t+1), a[1] (g + 8,
// 2t..), a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..); B (16 x 8, k x n)
// b0 (2t..2t+1, g), b1 (2t + 8.., g); C c[0..1] (g, 2t..2t+1), c[2..3]
// (g + 8, 2t..); the lower half of a register the lower index.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments, one a piece, of the k16 step that n8 accumulator tiles
// x0 (columns 0-7) and x1 (columns 8-15) cover: a[0] = x0's row g, a[1] its
// row g + 8, a[2], a[3] x1's; piece i is the bf16 rounding of what pieces
// 0 .. i - 1 leave of each value.
__device__ __forceinline__ void split(const float (&x0)[4],
                                      const float (&x1)[4],
                                      uint32_t (&a)[PIECES][4]) {
  float r[8] = {x0[0], x0[1], x0[2], x0[3], x1[0], x1[1], x1[2], x1[3]};
#pragma unroll
  for (int i = 0; i < PIECES; ++i)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * w], r[2 * w + 1]);
      a[i][w] = bits(h);
      if (i + 1 < PIECES) {
        const float2 f = __bfloat1622float2(h);
        r[2 * w] -= f.x;
        r[2 * w + 1] -= f.y;
      }
    }
}

// cp.async of rows r0 .. r0 + n - 1 of a (S, row)-strided bf16 operand into
// swizzled rows of D values, rows past S zero-filled; thread tid copies
// chunks tid, tid + THREADS, ... (scale_tile relies on that)
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int64_t r0, int n, int64_t S,
                                          int64_t row) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < n * C; i += THREADS) {
    const int r = i / C, c = i % C;
    // a row past S is zero-filled from a valid address that is not read
    const bool in = r0 + r < S;
    tf32x3::cp_async16(dst + chunk<C>(r, c),
                       in ? src + (r0 + r) * row + 8 * c : src, in);
  }
}

// load_rows of N rows with its trip count fixed at compile time: thread tid
// copies chunk tid % C of rows tid / C + RS j, RS = THREADS / C rows apart,
// whose swizzle is the same for every j (RS is a multiple of 8 from C = 8
// up, of 2 C below), so each copy's place moves by RS whole rows; rows past
// S are zero-filled
template <int D, int N>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int64_t r0, int64_t S,
                                          int64_t row) {
  constexpr int C = D / 8, RS = THREADS / C;
  static_assert(N % RS == 0, "a tile is whole strides of rows");
  const int r = threadIdx.x / C, c = threadIdx.x % C;
  bf16* d = dst + chunk<C>(r, c);
  const bf16* s = src + (r0 + r) * row + 8 * c;
  const int64_t step = RS * row;
  if (r0 + N <= S) {  // every row in range: no predicate
#pragma unroll
    for (int j = 0; j < N / RS; ++j)
      tf32x3::cp_async16(d + RS * j * D, s + j * step, true);
    return;
  }
  const int64_t left = S - r0 - r;  // this thread's rows in range: RS j < left
#pragma unroll
  for (int j = 0; j < N / RS; ++j) {
    // a row past S is zero-filled from a valid address that is not read
    const bool in = RS * j < left;
    tf32x3::cp_async16(d + RS * j * D, in ? s + j * step : src, in);
  }
}

// the A fragment of the 16 stationary rows from row r0 at k16 step ks
template <int C>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* rows,
                                       int r0, int ks, int lane) {
  const int m = lane >> 3;
  ldsm(a, rows + chunk<C>(r0 + 8 * (m & 1) + (lane & 7), 2 * ks + (m >> 1)));
}

// the B fragments of n8 tiles 2 nb and 2 nb + 1 (tile rows 16 nb + [0, 16))
// at k16 step ks over D: b[0], b[1] of the first, b[2], b[3] of the second
template <int C>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile,
                                       int nb, int ks, int lane) {
  const int m = lane >> 3;
  ldsm(b, tile + chunk<C>(16 * nb + 8 * (m >> 1) + (lane & 7),
                          2 * ks + (m & 1)));
}

// the B fragments of n8 tiles 2 dn and 2 dn + 1 over D at the k16 step of
// tile rows 16 kb + [0, 16) (the tile transposed)
template <int C>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int kb, int dn, int lane) {
  const int m = lane >> 3;
  ldsm_t(b, tile + chunk<C>(16 * kb + 8 * (m & 1) + (lane & 7),
                            2 * dn + (m >> 1)));
}

// dynamic shared memory bytes, registers a thread and resident blocks an
// SM of one kernel instance
template <auto Kernel>
int occupancy(size_t bytes, int64_t* out) {
  cudaError_t err = tf32x3::set_shared_memory<Kernel>((int)bytes);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, Kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                        THREADS, bytes);
  out[0] = (int64_t)bytes;
  out[1] = fa.numRegs;
  out[2] = blocks;
  return (int)err;
}

}  // namespace bf16_mma
