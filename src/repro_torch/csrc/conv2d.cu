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
// the reference is pure f32).  At the default tile a block of 256 threads
// owns a 128 x 32 output tile, narrow in n because n is 32 on the head; per
// step of 16 along k it stages a 128 x 16 slice of x (transposed, padded by
// 4 floats a row against bank conflicts) and a 16 x 32 slice of w in shared
// memory, zeros past every edge, and every thread accumulates a 4 x 4
// sub-tile in registers, in k order.
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
//
// conv2d_decode and conv2d_decode_encode replace _conv_dec_kernel and
// _conv_dec_enc_kernel (same file): the input edge arrives as its BFP8
// spill payload (row stride ceil(k / 32) * 32 bytes, one exponent per 32
// columns), and the A tile is staged from it, each value decoded on load
// with bfp8_decode (bfp8.cuh), the standalone decode's arithmetic; only the
// first k decoded columns enter the product.  kDecode is a second template
// parameter over the same product loop, so y is bit for bit the plain
// kernel's y on the bfp8_dequant kernel's output.  The decode reads 1 +
// 1/32 bytes per input value where the plain kernel reads 4.  On X3D-M's
// hand-cut plans K runs from 3 (the stem, whose input edge is evicted) to
// 384 and m from 1 (the squeeze-excitation convs) to 262144.
//
// Tiles (the plan's tile_bm / tile_bc, the reference's bm / bc): bm picks
// the template instance by its row tile, BM = 32, 64 or 128 with 2 BM
// threads a block (bm 0 is 128; a bm below 32 rounds up to 32, one
// between two instances up to the larger, one above 128 down to 128).
// bc sets the columns a block covers: bc / 32 column tiles of BN = 32, one
// after the other (bc 0 is 32).  Every thread sums its outputs over k in
// the same order whatever the tile, and a tile's staged values are exact
// copies, so no tile changes a result.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int BN = 32, BK = 16;

static_assert(BN == smof::kBfp8Block, "one tile column block = one block");

// x: the (m, k) input, or with kDecode its BFP8 payload decoded as the A
// tile is staged.  kEncode: also write the payload man (m, nb * 32) and exp
// (m, nb), with nb = ceil(n / 32).  Block y covers `ctiles` column tiles.
template <int BM, bool kDecode, bool kEncode>
__global__ void __launch_bounds__(2 * BM)
conv2d_kernel(smof::Stripe<kDecode> x, const float* __restrict__ w,
              float* __restrict__ y, int8_t* __restrict__ man,
              int8_t* __restrict__ exp, int64_t m, int64_t k, int64_t n,
              int ctiles) {
  constexpr int THREADS = 2 * BM;
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty..4ty+3, cols 4tx..4tx+3
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t nb = (n + BN - 1) / BN;

  for (int ct = 0; ct < ctiles; ++ct) {
  const int64_t cb = (int64_t)blockIdx.y * ctiles + ct;  // column tile
  if (cb >= nb) break;                                   // block-uniform
  const int64_t col0 = cb * BN;

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
      xs[xk][r] = (gr < m && gk < k) ? x.at(gr, gk) : 0.0f;
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
      if (tx == 0) exp[r * nb + cb] = static_cast<int8_t>(e);
    }
  }
  }
}

template <int BM, bool kDecode, bool kEncode>
int launch_conv2d(smof::Stripe<kDecode> x, const void* w, void* y, void* man,
                  void* exp, int64_t m, int64_t n, int ctiles,
                  cudaStream_t st) {
  const int64_t nb = (n + BN - 1) / BN;
  const dim3 grid((unsigned)((m + BM - 1) / BM),
                  (unsigned)((nb + ctiles - 1) / ctiles));
  conv2d_kernel<BM, kDecode, kEncode><<<grid, 2 * BM, 0, st>>>(
      x, (const float*)w, (float*)y, (int8_t*)man, (int8_t*)exp, m, x.c, n,
      ctiles);
  return (int)cudaGetLastError();
}

// bm, bc as the note at the top says.
template <bool kDecode, bool kEncode>
int run_conv2d(smof::Stripe<kDecode> x, const void* w, void* y, void* man,
               void* exp, int64_t m, int64_t n, int64_t bm, int64_t bc,
               void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const int ctiles = bc > 0 ? (int)((bc + BN - 1) / BN) : 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (bm > 0 && bm <= 32)
    return launch_conv2d<32, kDecode, kEncode>(x, w, y, man, exp, m, n,
                                               ctiles, st);
  if (bm > 0 && bm <= 64)
    return launch_conv2d<64, kDecode, kEncode>(x, w, y, man, exp, m, n,
                                               ctiles, st);
  return launch_conv2d<128, kDecode, kEncode>(x, w, y, man, exp, m, n,
                                              ctiles, st);
}

}  // namespace

// x: (m, k); w: (k, n); y: (m, n).  With the encode, man: (m, ceil(n / 32)
// * 32) and exp: (m, ceil(n / 32)); with the decode, xman: (m, ceil(k / 32)
// * 32) and xexp: (m, ceil(k / 32)) in place of x.  bm, bc: the tiles.
extern "C" int smof_conv2d(const void* x, const void* w, void* y, int64_t m,
                           int64_t k, int64_t n, int64_t bm, int64_t bc,
                           void* stream) {
  return run_conv2d<false, false>(smof::f32_stripe(x, k), w, y, nullptr,
                                  nullptr, m, n, bm, bc, stream);
}

extern "C" int smof_conv2d_encode(const void* x, const void* w, void* y,
                                  void* man, void* exp, int64_t m, int64_t k,
                                  int64_t n, int64_t bm, int64_t bc,
                                  void* stream) {
  return run_conv2d<false, true>(smof::f32_stripe(x, k), w, y, man, exp, m,
                                 n, bm, bc, stream);
}

extern "C" int smof_conv2d_decode(const void* xman, const void* xexp,
                                  const void* w, void* y, int64_t m,
                                  int64_t k, int64_t n, int64_t bm,
                                  int64_t bc, void* stream) {
  return run_conv2d<true, false>(smof::payload_stripe(xman, xexp, k), w, y,
                                 nullptr, nullptr, m, n, bm, bc, stream);
}

extern "C" int smof_conv2d_decode_encode(const void* xman, const void* xexp,
                                         const void* w, void* y, void* man,
                                         void* exp, int64_t m, int64_t k,
                                         int64_t n, int64_t bm, int64_t bc,
                                         void* stream) {
  return run_conv2d<true, true>(smof::payload_stripe(xman, xexp, k), w, y,
                                man, exp, m, n, bm, bc, stream);
}
