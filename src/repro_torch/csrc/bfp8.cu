// bfp8_dequant: int8 mantissas (R, C) and int8 shared exponents (R, C/32)
// back to f32, y = man * 2^(exp-6).
//
// Replaces the TPU kernel _dequant_kernel (src/repro/kernels/bfp8.py,
// bfp8_dequant).  Bound on the H100 by bytes: it reads 1 + 1/32 bytes and
// writes 4 bytes per value and does one multiply, so it can only run at the
// memory rate.  Design: each thread takes four neighbouring values (one
// 4-byte load of mantissas, one 16-byte store), which stay inside one
// 32-wide block because C is a multiple of 32; loads and stores of a warp
// are contiguous.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

__global__ void bfp8_dequant_kernel(const char4* __restrict__ man,
                                    const int8_t* __restrict__ exp,
                                    float4* __restrict__ y, int64_t n4,
                                    int64_t c) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  int64_t flat = i * 4;
  int64_t row = flat / c, col = flat - row * c;
  float s = smof::bfp8_scale(exp[row * (c / smof::kBfp8Block) +
                                 col / smof::kBfp8Block]);
  char4 m = man[i];
  y[i] = make_float4(m.x * s, m.y * s, m.z * s, m.w * s);
}

}  // namespace

extern "C" int smof_bfp8_dequant(const void* man, const void* exp, void* y,
                                 int64_t rows, int64_t c, void* stream) {
  int64_t n4 = rows * c / 4;
  if (n4 > 0) {
    int threads = 256;
    int64_t blocks = (n4 + threads - 1) / threads;
    bfp8_dequant_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const char4*)man, (const int8_t*)exp, (float4*)y, n4, c);
  }
  return (int)cudaGetLastError();
}
