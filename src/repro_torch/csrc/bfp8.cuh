// BFP8 codec numerics shared by the kernels that quantise or dequantise a
// 32-wide channel block (the paper's §V-A format: int8 mantissas plus one
// int8 shared exponent per block).
//
// One definition, used by every kernel and mirrored bit for bit by
// repro_torch/kernels/bfp8.py (the plain PyTorch version):
//   exp = ceil(log2(max(amax, 1e-38)))  for a finite amax > 0, else 0
//         (a block holding a NaN has amax NaN, as torch.amax gives it),
//         read exactly from the float's bits (frexp), never through an
//         approximate log2;
//   man = clip(rint(x / 2^(exp-6)), -127, 127), rint rounding half to
//         even (never roundf, which rounds half away from zero); a NaN
//         value's mantissa is 0;
//   and back: x = man * 2^(exp-6), one IEEE multiply (bfp8_decode).
// The build uses no --use_fast_math: subnormals are kept and the division
// is IEEE, so x / 2^(exp-6) is exact.
#pragma once

#include <cstdint>

namespace smof {

constexpr int kBfp8Block = 32;

// ceil(log2(a)) for a > 0, exactly: frexpf gives a = f * 2^e, f in [0.5, 1);
// a is a power of two exactly when f == 0.5, and then log2(a) = e - 1.
__device__ __forceinline__ int bfp8_exponent(float amax) {
  if (!(amax > 0.0f) || isinf(amax)) return 0;
  int e;
  float f = frexpf(fmaxf(amax, 1e-38f), &e);
  return f == 0.5f ? e - 1 : e;
}

// One step of a block's amax reduction.  Unlike fmaxf it keeps a NaN, so a
// block that holds one gets exponent 0 as the plain version's amax gives it.
__device__ __forceinline__ float bfp8_amax_step(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// 2^(exp-6) as an exact float (a subnormal where exp-6 < -126).
__device__ __forceinline__ float bfp8_scale(int exp) {
  return ldexpf(1.0f, exp - 6);
}

__device__ __forceinline__ int8_t bfp8_mantissa(float x, float scale) {
  float q = rintf(x / scale);
  if (isnan(q)) return 0;
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// The payload of one 32-channel block held by kLanes neighbouring lanes (an
// aligned group of the warp), kVals values a lane, kLanes * kVals = 32: the
// block's amax over each lane's own values, then a butterfly of
// __shfl_xor_sync inside the group.  Writes the lane's mantissas to q and
// returns the block's exponent.  Values in channels past c are 0, as the
// spill's channel padding quantises zeros.  Every lane of the warp must
// call it (with the same kLanes).
template <int kLanes, int kVals>
__device__ __forceinline__ int bfp8_encode_group(const float (&v)[kVals],
                                                 int8_t (&q)[kVals]) {
  static_assert(kLanes * kVals == kBfp8Block, "one group holds one block");
  float amax = fabsf(v[0]);
#pragma unroll
  for (int i = 1; i < kVals; ++i) amax = bfp8_amax_step(amax, fabsf(v[i]));
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    amax = bfp8_amax_step(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int e = bfp8_exponent(amax);
  const float scale = bfp8_scale(e);
#pragma unroll
  for (int i = 0; i < kVals; ++i) q[i] = bfp8_mantissa(v[i], scale);
  return e;
}

// The group encode with a whole warp on one block: lane l holds channel
// 32*b + l, writes man_block[l], and lane 0 the exponent.
__device__ __forceinline__ void bfp8_encode_warp(float v, int8_t* man_block,
                                                 int8_t* exp_at, int lane) {
  const float vs[1] = {v};
  int8_t q[1];
  const int e = bfp8_encode_group<kBfp8Block, 1>(vs, q);
  man_block[lane] = q[0];
  if (lane == 0) *exp_at = static_cast<int8_t>(e);
}

// One payload element back to f32, man * 2^(exp-6): the standalone
// bfp8_dequant kernel and every fused ingress decode call this, so fused and
// unfused decodes give the same bits.  __fmul_rn keeps nvcc from contracting
// the product into an FMA with the caller's next addition (a pool's sum).
// bfp8_decode_scaled takes the block's bfp8_scale(exp), for a kernel that
// decodes many values of one block.
__device__ __forceinline__ float bfp8_decode_scaled(int8_t man, float scale) {
  return __fmul_rn(static_cast<float>(man), scale);
}

__device__ __forceinline__ float bfp8_decode(int8_t man, int8_t exp) {
  return bfp8_decode_scaled(man, bfp8_scale(exp));
}

// A kernel's (rows, c) input: an f32 stripe (x, row stride c) or, with
// kDecode, its BFP8 spill payload (man (rows, nb * 32), exp (rows, nb),
// nb = ceil(c / 32)) decoded on load.  Only channels below c are read, so
// the payload's padding channels never enter the op.
template <bool kDecode>
struct Stripe {
  const float* x;
  const int8_t* man;
  const int8_t* exp;
  int64_t c, nb;

  __device__ __forceinline__ float at(int64_t row, int64_t ch) const {
    if constexpr (kDecode)
      return bfp8_decode(man[row * nb * kBfp8Block + ch],
                         exp[row * nb + ch / kBfp8Block]);
    else
      return x[row * c + ch];
  }
};

inline Stripe<false> f32_stripe(const void* x, int64_t c) {
  return {static_cast<const float*>(x), nullptr, nullptr, c, 0};
}

inline Stripe<true> payload_stripe(const void* man, const void* exp,
                                   int64_t c) {
  return {nullptr, static_cast<const int8_t*>(man),
          static_cast<const int8_t*>(exp), c,
          (c + kBfp8Block - 1) / kBfp8Block};
}

}  // namespace smof
