// The element types of the attention kernels' operands in global memory,
// f32 or bf16 (__nv_bfloat16), and where a kernel rounds as the plain route
// does: D^-1/2 as it multiplies an operand of either type (head_scale, the
// f32 bodies and the bf16 ones), and a pair of bf16 outputs each rounded
// once, to nearest even, as it is stored (store2, the bf16 backward pair).
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

// two consecutive outputs, rounded once to bf16
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
