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
//         value's mantissa is 0.
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

}  // namespace smof
