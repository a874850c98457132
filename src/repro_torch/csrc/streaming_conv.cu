// act_relu and pool: the row-streaming elementwise and pooling kernels.
//
// act_relu replaces the TPU kernels _act_kernel and _act_enc_kernel
// (src/repro/kernels/streaming_conv.py, act_relu); pool replaces
// _pool_kernel (same file, pool).  On the H100 all three are bound by
// bytes: relu does one compare per 8 bytes moved, the egress encode adds
// a 32-lane max and one division per value, and pool adds k-1 additions per
// output.  The designs therefore only aim at full-width, coalesced loads and
// stores:
//  * act_relu (plain): four values per thread, 16-byte loads and stores;
//    the thread at the end of a ragged n takes the n % 4 left one by one;
//  * act_relu (egress encode): one warp per (row, 32-channel block).  Lane l
//    owns channel 32*b + l, the block's amax is a butterfly of
//    __shfl_xor_sync, and the f32 output, the mantissas and the block's
//    exponent are written from the same registers, so the payload costs
//    1 + 1/32 extra bytes per value and no second pass over the output;
//  * pool: one thread per output value; neighbouring threads take
//    neighbouring channels, so each of the k row reads is coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

// relu as the plain version computes it (torch.relu): NaN and -0.0 pass
// through unchanged.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

__global__ void act_relu_kernel(const float* __restrict__ x,
                                float* __restrict__ y, int64_t n) {
  int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n) {
    float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(y + i) =
        make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
  } else {
    for (; i < n; ++i) y[i] = relu(x[i]);
  }
}

// One warp per (row, block); c_pad = ceil(c / 32) * 32 channels of payload,
// the padded channels quantise zeros as bfp8_spill_encode does.
__global__ void act_relu_encode_kernel(const float* __restrict__ x,
                                       float* __restrict__ y,
                                       int8_t* __restrict__ man,
                                       int8_t* __restrict__ exp, int64_t m,
                                       int64_t c, int64_t nb) {
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (warp >= m * nb) return;  // whole warps leave together
  int64_t row = warp / nb, b = warp - row * nb;
  int64_t col = b * smof::kBfp8Block + lane;
  float v = 0.0f;
  if (col < c) {
    v = relu(x[row * c + col]);
    y[row * c + col] = v;
  }
  float amax = fabsf(v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = smof::bfp8_amax_step(amax,
                                __shfl_xor_sync(0xffffffffu, amax, off));
  int e = smof::bfp8_exponent(amax);
  man[row * nb * smof::kBfp8Block + col] =
      smof::bfp8_mantissa(v, smof::bfp8_scale(e));
  if (lane == 0) exp[row * nb + b] = static_cast<int8_t>(e);
}

__global__ void pool_kernel(const float* __restrict__ x, float* __restrict__ y,
                            int64_t m_out, int64_t k, int64_t c) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= m_out * c) return;
  int64_t o = i / c, ch = i - o * c;
  const float* p = x + o * k * c + ch;
  float s = 0.0f;
  for (int64_t j = 0; j < k; ++j) s += p[j * c];
  y[i] = s / static_cast<float>(k);
}

unsigned grid_for(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

}  // namespace

extern "C" int smof_act_relu(const void* x, void* y, int64_t n, void* stream) {
  if (n > 0)
    act_relu_kernel<<<grid_for((n + 3) / 4, 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

extern "C" int smof_act_relu_encode(const void* x, void* y, void* man,
                                    void* exp, int64_t m, int64_t c,
                                    void* stream) {
  int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m * nb > 0)
    act_relu_encode_kernel<<<grid_for(m * nb * 32, 256), 256, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, (int8_t*)man, (int8_t*)exp, m, c, nb);
  return (int)cudaGetLastError();
}

extern "C" int smof_pool(const void* x, void* y, int64_t m_out, int64_t k,
                         int64_t c, void* stream) {
  if (m_out * c > 0)
    pool_kernel<<<grid_for(m_out * c, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, m_out, k, c);
  return (int)cudaGetLastError();
}
