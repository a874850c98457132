// The element types of the attention kernels' operands in global memory:
// f32, or bf16 (__nv_bfloat16).  The forward kernels (flash_attention.cu)
// stage every operand in shared memory as f32 and compute in f32 whatever
// the type, so a bf16 instance differs from the f32 one only where values
// cross global memory: a load widens each bf16 value to f32 (exact), q^ = q
// D^-1/2 is rounded to the operand type as the plain route rounds it
// (round_to), and each output is rounded once, to nearest even, as it is
// stored (store2, which the bf16 backward pair uses too).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace elem {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool is_f32 = std::is_same_v<T, float>;

// 4 consecutive values as f32: one 16-byte load (f32) or one 8-byte load
// (bf16); the address is aligned to 4 values
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  bf16 h[4];
  memcpy(h, &u, sizeof(u));
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

// x rounded to T (to nearest even) and widened back: the identity for f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (is_f32<T>)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

// two consecutive outputs, rounded once to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  bf16 h[2] = {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
  uint32_t u;
  memcpy(&u, h, sizeof(u));
  *reinterpret_cast<uint32_t*>(p) = u;
}

// D^-1/2 as the plain route multiplies an operand of type T by it: rounded
// once to f32 (the reference's q * D ** -0.5 on f32), and for bf16 on to
// bf16, to nearest even, as the reference converts a Python scale to a bf16
// array's type
template <typename T>
inline float head_scale(int D) {
  float s = (float)(1.0 / std::sqrt((double)D));
  if constexpr (!is_f32<T>) {
    uint32_t u;
    memcpy(&u, &s, sizeof(u));
    u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
    memcpy(&s, &u, sizeof(u));
  }
  return s;
}

}  // namespace elem
