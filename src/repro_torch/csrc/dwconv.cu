// dwconv: the depthwise temporal conv, y[i, ch] = sum_t w[t, ch] *
// x[i + t - taps/2, ch] with zero 'same' padding; x and y (m, c), w (taps, c);
// with the fused BFP8 boundary codec.
//
// Replaces the TPU kernels _dwconv_kernel, _dwconv_dec_kernel,
// _dwconv_enc_kernel and _dwconv_dec_enc_kernel (src/repro/kernels/
// streaming_conv.py, dwconv).  There the input stays un-blocked and each
// grid step reads its overlapping tap windows with pl.ds, the line-buffer
// access pattern (the ingress variants hold the whole payload for the same
// reason).  Here each block owns `tr` consecutive output rows (the plan's
// tile_bm where it is set, else about kValuesPerBlock values) and stages
// the rows it reads, tr + taps - 1 of them with the halo, in shared memory:
// the rows are contiguous in memory, so the stage is one coalesced copy,
// zeros where a row lies outside [0, m).  Bound on the H100 by bytes: 8
// bytes move per output (5 + 1/32 with one side encoded, 2 + 1/16 with
// both) and taps multiply-adds are done on them; the halo re-reads
// (taps - 1) / tr rows per block, mostly from L2.
//
// One template over the four variants:
//  * kDecode: the tile is staged from the input's BFP8 payload, each value
//    decoded on load with bfp8_decode (bfp8.cuh), the standalone decode's
//    own arithmetic; the 'same'-padding rows stay zeros and are never
//    decoded, and the payload's padding channels are never read;
//  * kEncode: the output side maps (row, 32-channel block, lane) instead of
//    one thread per r*c + ch (at c = 48 a warp of the plain mapping spans
//    two rows), so each warp holds one row's codec block and writes its f32
//    values, mantissas and exponent from the same registers.
//
// Numerics: y is bit for bit the plain version's (kernels/ref.py,
// dwconv_ref), which sums the taps in Python `sum` order, ((0 + w0 x0) +
// w1 x1) + w2 x2, with every product and sum rounded on its own, whatever the
// variant.  nvcc would contract a * b + c into an FMA, so the kernel spells
// each step with __fmul_rn and __fadd_rn; the leading 0 + turns -0.0 into
// +0.0 as Python's sum does.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kValuesPerBlock = 2048;
constexpr int64_t kMaxSmem = 232448;  // dynamic shared memory of a block

// Output row r (of the block) and channel ch from the staged tile.
__device__ __forceinline__ float tap_sum(const float* __restrict__ w,
                                         const float* tile, int r, int ch,
                                         int c, int taps) {
  float s = 0.0f;
  for (int t = 0; t < taps; ++t)
    s = __fadd_rn(s, __fmul_rn(w[t * c + ch], tile[(r + t) * c + ch]));
  return s;
}

template <bool kDecode, bool kEncode>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(smof::Stripe<kDecode> in, const float* __restrict__ w,
              float* __restrict__ y, int8_t* __restrict__ man,
              int8_t* __restrict__ exp, int64_t m, int taps, int tr) {
  extern __shared__ float tile[];  // (tr + taps - 1) rows of c
  const int c = (int)in.c;
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int64_t first = r0 - taps / 2;  // input row of tile row 0
  const int n_in = (tr + taps - 1) * c;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int64_t row = first + i / c;
    tile[i] = (row >= 0 && row < m) ? in.at(row, i % c) : 0.0f;
  }
  __syncthreads();
  const int rows = (int)(m - r0 < tr ? m - r0 : tr);
  if constexpr (!kEncode) {
    float* out = y + r0 * c;
    for (int i = threadIdx.x; i < rows * c; i += kThreads) {
      const int r = i / c;
      out[i] = tap_sum(w, tile, r, i - r * c, c, taps);
    }
  } else {
    const int nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
    const int lane = threadIdx.x & 31;
    // warp-uniform loop: every lane of a warp takes the same (row, block)
    for (int j = threadIdx.x >> 5; j < rows * nb; j += kThreads / 32) {
      const int r = j / nb, b = j - r * nb, ch = b * smof::kBfp8Block + lane;
      const int64_t row = r0 + r;
      float v = 0.0f;
      if (ch < c) {
        v = tap_sum(w, tile, r, ch, c, taps);
        y[row * c + ch] = v;
      }
      smof::bfp8_encode_warp(v, man + (row * nb + b) * smof::kBfp8Block,
                             exp + row * nb + b, lane);
    }
  }
}

// Rows a block owns: bm (the plan's tile_bm) where it is > 0, else about
// kValuesPerBlock values' worth; cut down to what the shared memory of one
// block holds with the halo.  The tile never changes a result: each output
// is its own tap_sum.
int64_t dwconv_rows(int64_t bm, int64_t c, int64_t taps) {
  int64_t tr = bm > 0 ? bm : (kValuesPerBlock / c > 0 ? kValuesPerBlock / c
                                                       : 1);
  const int64_t fit = kMaxSmem / (int64_t)(c * sizeof(float)) - (taps - 1);
  return tr < fit ? tr : (fit > 1 ? fit : 1);
}

template <bool kDecode, bool kEncode>
int run_dwconv(smof::Stripe<kDecode> in, const void* w, void* y, void* man,
               void* exp, int64_t m, int64_t taps, int64_t bm,
               void* stream) {
  const int64_t c = in.c;
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  const int tr = (int)dwconv_rows(bm, c, taps);
  const size_t smem = (size_t)(tr + taps - 1) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dwconv_kernel<kDecode, kEncode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dwconv_kernel<kDecode, kEncode><<<(unsigned)((m + tr - 1) / tr), kThreads,
                                    smem, (cudaStream_t)stream>>>(
      in, (const float*)w, (float*)y, (int8_t*)man, (int8_t*)exp, m,
      (int)taps, tr);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (m, c); w: (taps, c).  With the encode, man: (m, nb * 32) and exp:
// (m, nb), nb = ceil(c / 32); with the decode the input is its payload of
// the same shapes.
extern "C" int smof_dwconv(const void* x, const void* w, void* y, int64_t m,
                           int64_t c, int64_t taps, int64_t bm,
                           void* stream) {
  return run_dwconv<false, false>(smof::f32_stripe(x, c), w, y, nullptr,
                                  nullptr, m, taps, bm, stream);
}

extern "C" int smof_dwconv_encode(const void* x, const void* w, void* y,
                                  void* man, void* exp, int64_t m, int64_t c,
                                  int64_t taps, int64_t bm, void* stream) {
  return run_dwconv<false, true>(smof::f32_stripe(x, c), w, y, man, exp, m,
                                 taps, bm, stream);
}

extern "C" int smof_dwconv_decode(const void* xman, const void* xexp,
                                  const void* w, void* y, int64_t m,
                                  int64_t c, int64_t taps, int64_t bm,
                                  void* stream) {
  return run_dwconv<true, false>(smof::payload_stripe(xman, xexp, c), w, y,
                                 nullptr, nullptr, m, taps, bm, stream);
}

extern "C" int smof_dwconv_decode_encode(const void* xman, const void* xexp,
                                         const void* w, void* y, void* man,
                                         void* exp, int64_t m, int64_t c,
                                         int64_t taps, int64_t bm,
                                         void* stream) {
  return run_dwconv<true, true>(smof::payload_stripe(xman, xexp, c), w, y,
                                man, exp, m, taps, bm, stream);
}
