// BFP8 codec numerics shared by the kernels that quantise or dequantise a
// 32-wide channel block (the paper's §V-A format: int8 mantissas plus one
// int8 shared exponent per block).
//
// One definition, used by every kernel and mirrored bit for bit by
// repro_torch/kernels/bfp8.py (the plain PyTorch version):
//   exp = ceil(log2(max(amax, 1e-38)))  for a finite amax > 0, else 0
//         (a block holding a NaN has amax NaN, as torch.amax gives it),
//         read exactly from the float's bits, never through an
//         approximate log2;
//   man = clip(rint(x / 2^(exp-6)), -127, 127), rint rounding half to
//         even (never roundf, which rounds half away from zero); a NaN
//         value's mantissa is 0;
//   and back: x = man * 2^(exp-6), one IEEE multiply (bfp8_decode).
// The build uses no --use_fast_math: subnormals are kept and x / 2^(exp-6)
// is rounded once, as the IEEE division rounds it (bfp8_mantissa).
#pragma once

#include <cstdint>

namespace smof {

constexpr int kBfp8Block = 32;

// ceil(log2(a)) for a > 0, exactly, from the float's bits: a normal a =
// 1.m * 2^(E - 127) gives E - 127 where m == 0 (a power of two), else
// E - 126; a subnormal a = M * 2^-149 gives ceil(log2(M)) - 149, and
// ceil(log2(M)) = 32 - clz(M - 1).  (frexpf's e, less one at a power of
// two, without a call into the math library.)
__device__ __forceinline__ int bfp8_exponent(float amax) {
  if (!(amax > 0.0f) || isinf(amax)) return 0;
  const int bits = __float_as_int(fmaxf(amax, 1e-38f));
  const int e = bits >> 23, m = bits & 0x7fffff;
  if (e == 0) return 32 - __clz(m - 1) - 149;
  return m == 0 ? e - 127 : e - 126;
}

// One step of a block's amax reduction.  Unlike fmaxf it keeps a NaN, so a
// block that holds one gets exponent 0 as the plain version's amax gives it.
__device__ __forceinline__ float bfp8_amax_step(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// 2^(exp-6) as an exact float (a subnormal where exp-6 < -126), built from
// its bits: ldexpf(1, exp - 6)'s value without a call into the math
// library.
__device__ __forceinline__ float bfp8_scale(int exp) {
  const int n = exp - 6;
  if (n > 127) return __int_as_float(0x7f800000);
  if (n >= -126) return __int_as_float((n + 127) << 23);
  return n >= -149 ? __int_as_float(1 << (n + 149)) : 0.0f;
}

// x / scale is exact arithmetic on a power of two: where scale is normal,
// x times its reciprocal (a power of two too, so exact) is the same
// correctly rounded value as the IEEE division, for a fraction of its
// instructions; a subnormal scale divides.
__device__ __forceinline__ int8_t bfp8_mantissa(float x, float scale) {
  const int bits = __float_as_int(scale);
  float q = rintf(bits >= 0x00800000 ? x * __int_as_float(0x7f000000 - bits)
                                     : x / scale);
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

  // The same stripe from row `row` on: a kernel moves its base once and
  // indexes the rows it owns with 32-bit offsets.
  __host__ __device__ __forceinline__ Stripe from_row(int64_t row) const {
    Stripe s = *this;
    if constexpr (kDecode) {
      s.man += row * nb * kBfp8Block;
      s.exp += row * nb;
    } else {
      s.x += row * c;
    }
    return s;
  }

  // Channels ch .. ch + 3 of row `row` (ch % 4 == 0); channels at or past
  // c read as 0 and are never loaded.  kVec: c % 4 == 0 and the rows may
  // be read 16 bytes (f32) or 4 bytes (mantissas) at a time; else one by
  // one.  The decode takes its block's scale once for the four values,
  // which gives bfp8_decode's bits.
  template <bool kVec>
  __device__ __forceinline__ float4 quad(int row, int ch) const {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int ci = static_cast<int>(c);
    if (ch >= ci) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kDecode) {
      const int width = static_cast<int>(nb) * kBfp8Block;
      const int8_t* mp = man + row * width + ch;
      const float scale =
          bfp8_scale(exp[row * static_cast<int>(nb) + ch / kBfp8Block]);
      if constexpr (kVec) {
        const char4 mv = *reinterpret_cast<const char4*>(mp);
        return make_float4(bfp8_decode_scaled(mv.x, scale),
                           bfp8_decode_scaled(mv.y, scale),
                           bfp8_decode_scaled(mv.z, scale),
                           bfp8_decode_scaled(mv.w, scale));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < ci) v[j] = bfp8_decode_scaled(mp[j], scale);
    } else {
      const float* xp = x + row * ci + ch;
      if constexpr (kVec) return *reinterpret_cast<const float4*>(xp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < ci) v[j] = xp[j];
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }

  __device__ __forceinline__ float4 quad(int row, int ch, bool vec) const {
    return vec ? quad<true>(row, ch) : quad<false>(row, ch);
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
