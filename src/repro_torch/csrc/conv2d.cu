// conv2d: the 1x1 channel mix y = x @ w in f32 for conv, matmul and deconv
// vertices whose weight the plan pins whole; x (m, k), w (k, n), y (m, n),
// all three ragged.
//
// Replaces the TPU kernel _conv_kernel (src/repro/kernels/streaming_conv.py,
// conv2d), one full-K jnp.dot per (row block, column block) tile.  The
// shapes it meets on the X3D path are small: the squeeze-excitation
// bottlenecks at m = 1 (k x n from 32 x 48 to 384 x 32), which are bound by
// launch latency, and the classifier head at m = 32768, k = 216, n = 32,
// which at 2 m k n flops on (m k + k n + m n) * 4 bytes is bound by bytes
// (about 7 flops per byte, under the f32 ridge of the card).  Design: a
// register-blocked SGEMM with bounds checks and plain f32 FMAs (no TF32,
// the reference is pure f32).  A block of 256 threads owns a 128 x 32
// output tile, narrow in n because n is 32 on the head; per step of 16
// along k it stages a 128 x 16 slice of x (transposed, padded by 4 floats a
// row against bank conflicts) and a 16 x 32 slice of w in shared memory,
// zeros past every edge, and every thread accumulates a 4 x 4 sub-tile in
// registers, in k order.
//
// conv2d_encode replaces _conv_enc_kernel (same file): the same product and,
// from the same launch, the BFP8 spill payload of y zero-padded to the
// 32-channel block (int8 mantissas (m, n32), one int8 exponent per row and
// block (m, n32 / 32)).  The tile is 32 output columns wide, so a tile's
// columns are exactly one codec block of each of its rows, and the encode
// is the tile's epilogue: the 8 threads that hold a row's 32 values take
// the block's amax over their 4 values and then over each other (3 steps
// of __shfl_xor_sync), and each writes its f32 values, its 4 mantissas as
// one char4 and, for the first of them, the exponent, with the codec of
// bfp8.cuh.  Columns n..n32 encode zeros, as the plain version pads y; rows
// past m write nothing.  The product loop is the plain kernel's (one
// template), so y is bit for bit the plain kernel's y.  Bound on the YOLO
// head: at (25600, 64) @ (64, 64) it moves 14.8 MB (x, w, y, payload) for
// 0.21 GFLOP, bound by bytes (4.4 us at 3.35 TB/s); at the 3-stage plan's
// conv_12, (12800, 384) @ (384, 128), 28.1 MB for 1.26 GFLOP, bound by
// operations (18.8 us at 67 TFLOP/s f32).
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int BM = 128, BN = 32, BK = 16, THREADS = 256;

static_assert(BN == smof::kBfp8Block, "one tile column block = one block");

// kEncode: also write the payload man (m, nb * 32) and exp (m, nb), with
// nb = gridDim.y = ceil(n / 32).
template <bool kEncode>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int8_t* __restrict__ man,
              int8_t* __restrict__ exp, int64_t m, int64_t k, int64_t n) {
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty..4ty+3, cols 4tx..4tx+3
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const int xk = tid & (BK - 1);
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {
      const int r = (tid >> 4) + j * (THREADS / BK);
      const int64_t gr = row0 + r, gk = k0 + xk;
      xs[xk][r] = (gr < m && gk < k) ? x[gr * k + gk] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int kk = (tid >> 5) + j * (THREADS / BN);
      const int64_t gk = k0 + kk, gc = col0 + (tid & (BN - 1));
      ws[kk][tid & (BN - 1)] = (gk < k && gc < n) ? w[gk * n + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if constexpr (!kEncode) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + ty * 4 + i;
      if (r >= m) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t cc = col0 + tx * 4 + j;
        if (cc < n) y[r * n + cc] = acc[i][j];
      }
    }
  } else {
    const int64_t nb = gridDim.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + ty * 4 + i;
      float v[4];
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = col0 + tx * 4 + j < n ? acc[i][j] : 0.0f;
        amax = smof::bfp8_amax_step(amax, fabsf(v[j]));
      }
      // the row's 8 threads are 8 neighbouring lanes (lane = 8 (ty % 4) +
      // tx); every lane of the warp takes part, rows past m included
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        amax = smof::bfp8_amax_step(amax,
                                    __shfl_xor_sync(0xffffffffu, amax, off));
      if (r >= m) continue;
      const int e = smof::bfp8_exponent(amax);
      const float scale = smof::bfp8_scale(e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t cc = col0 + tx * 4 + j;
        if (cc < n) y[r * n + cc] = v[j];
      }
      *reinterpret_cast<char4*>(man + r * nb * BN + col0 + tx * 4) =
          make_char4(smof::bfp8_mantissa(v[0], scale),
                     smof::bfp8_mantissa(v[1], scale),
                     smof::bfp8_mantissa(v[2], scale),
                     smof::bfp8_mantissa(v[3], scale));
      if (tx == 0) exp[r * nb + blockIdx.y] = static_cast<int8_t>(e);
    }
  }
}

dim3 conv2d_grid(int64_t m, int64_t n) {
  return dim3((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
}

}  // namespace

extern "C" int smof_conv2d(const void* x, const void* w, void* y, int64_t m,
                           int64_t k, int64_t n, void* stream) {
  if (m > 0 && n > 0)
    conv2d_kernel<false><<<conv2d_grid(m, n), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, nullptr, nullptr, m, k,
        n);
  return (int)cudaGetLastError();
}

// man: (m, ceil(n / 32) * 32) int8, exp: (m, ceil(n / 32)) int8.
extern "C" int smof_conv2d_encode(const void* x, const void* w, void* y,
                                  void* man, void* exp, int64_t m, int64_t k,
                                  int64_t n, void* stream) {
  if (m > 0 && n > 0)
    conv2d_kernel<true><<<conv2d_grid(m, n), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, (int8_t*)man,
        (int8_t*)exp, m, k, n);
  return (int)cudaGetLastError();
}
