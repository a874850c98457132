// bfp8_quant and bfp8_dequant: the standalone BFP8 stripe codec, f32 (R, C)
// <-> int8 mantissas (R, C) and int8 shared exponents (R, C/32).
//
// bfp8_quant replaces the TPU kernel _quant_kernel (src/repro/kernels/
// bfp8.py, bfp8_quant): the encode of an evicted stream whose producer
// cannot emit its payload itself (a multi-input add, a fragmented conv).
// Bound on the H100 by bytes: it reads 4 bytes and writes 1 + 1/32 bytes
// per value, with a 32-lane max and one division per value.  Design: one
// warp per (row, 32-channel block), the layout of act_relu's egress encode
// (streaming_conv.cu) without the relu: lane l loads channel 32*b + l (the
// warp's 128 bytes are contiguous), the block's amax is a butterfly of
// __shfl_xor_sync, and every lane writes its mantissa, lane 0 the exponent.
//
// bfp8_dequant replaces _dequant_kernel (same file, bfp8_dequant), y = man *
// 2^(exp-6).  Bound by bytes: it reads 1 + 1/32 bytes and writes 4 bytes per
// value and does one multiply, so it can only run at the memory rate.
// Design: each thread takes four neighbouring values (one 4-byte load of
// mantissas, one 16-byte store), which stay inside one 32-wide block
// because C is a multiple of 32; loads and stores of a warp are contiguous.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

__global__ void bfp8_quant_kernel(const float* __restrict__ x,
                                  int8_t* __restrict__ man,
                                  int8_t* __restrict__ exp, int64_t warps) {
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  if (warp >= warps) return;  // whole warps leave together
  int lane = threadIdx.x & 31;
  // warp w holds the flat values [32w, 32w + 32)
  smof::bfp8_encode_warp(x[warp * smof::kBfp8Block + lane],
                         man + warp * smof::kBfp8Block, exp + warp, lane);
}

__global__ void bfp8_dequant_kernel(const char4* __restrict__ man,
                                    const int8_t* __restrict__ exp,
                                    float4* __restrict__ y, int64_t n4,
                                    int64_t c) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  int64_t flat = i * 4;
  int64_t row = flat / c, col = flat - row * c;
  int8_t e = exp[row * (c / smof::kBfp8Block) + col / smof::kBfp8Block];
  char4 m = man[i];
  y[i] = make_float4(smof::bfp8_decode(m.x, e), smof::bfp8_decode(m.y, e),
                     smof::bfp8_decode(m.z, e), smof::bfp8_decode(m.w, e));
}

}  // namespace

// x: (rows, c) f32 with c % 32 == 0; man: (rows, c); exp: (rows, c / 32).
extern "C" int smof_bfp8_quant(const void* x, void* man, void* exp,
                               int64_t rows, int64_t c, void* stream) {
  int64_t warps = rows * (c / smof::kBfp8Block);
  if (warps > 0) {
    int threads = 256;
    int64_t blocks = (warps * 32 + threads - 1) / threads;
    bfp8_quant_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)man, (int8_t*)exp, warps);
  }
  return (int)cudaGetLastError();
}

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
