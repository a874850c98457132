// act_relu and pool: the row-streaming elementwise and pooling kernels.
//
// act_relu replaces the TPU kernels _act_kernel and _act_enc_kernel
// (src/repro/kernels/streaming_conv.py, act_relu); pool replaces
// _pool_kernel and _pool_enc_kernel (same file, pool).  On the H100 all of
// them are bound by bytes: relu does one compare per 8 bytes moved, the
// egress encode adds a 32-lane max and one division per value, and pool one
// addition per 4 bytes read.  The designs therefore aim at full-width,
// coalesced loads and stores, and at enough blocks in flight:
//  * act_relu (plain): four values per thread, 16-byte loads and stores;
//    the thread at the end of a ragged n takes the n % 4 left one by one;
//  * act_relu and pool (egress encode): one warp per (row, 32-channel
//    block).  Lane l owns channel 32*b + l, the block's amax is a butterfly
//    of __shfl_xor_sync, and the f32 output, the mantissas and the block's
//    exponent are written from the same registers, so the payload costs
//    1 + 1/32 extra bytes per value and no second pass over the output;
//  * pool over few rows (k <= kPoolSerialMaxK, the 2:1 downsampling): one
//    thread per output value sums its k rows in order; neighbouring threads
//    take neighbouring channels, so each row read is coalesced;
//  * pool over many rows (the SE global pool, k up to 262144 at few
//    channels): one thread per output would leave the card idle and sum
//    in one long f32 chain.  A tree instead: each block reduces a chunk of
//    kPoolChunk rows for 32 channels (8 warps, each warp one row at a time,
//    lane = channel, then a shared-memory tree over the 8 warps), and the
//    per-chunk sums go through the same kernel again until one row is left.
//    The longest serial chain is kPoolChunk / 8 = 32 additions per pass.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int64_t kPoolSerialMaxK = 8;
constexpr int64_t kPoolChunk = 256;
constexpr int kPoolRowLanes = 8;  // warps of a tree block

// relu as the plain version computes it (torch.where(x < 0, 0, x)): NaN
// and -0.0 pass through unchanged.
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

// The payload of one (row, block) held by a warp, lane l holding channel
// 32*b + l of value v (0 in the padded channels, as bfp8_spill_encode
// quantises the block-padded stripe).
__device__ __forceinline__ void encode_block(float v, int8_t* man_row,
                                             int8_t* exp_at, int lane,
                                             int64_t b) {
  float amax = fabsf(v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = smof::bfp8_amax_step(amax,
                                __shfl_xor_sync(0xffffffffu, amax, off));
  int e = smof::bfp8_exponent(amax);
  man_row[b * smof::kBfp8Block + lane] =
      smof::bfp8_mantissa(v, smof::bfp8_scale(e));
  if (lane == 0) *exp_at = static_cast<int8_t>(e);
}

// One warp per (row, block); c_pad = ceil(c / 32) * 32 channels of payload.
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
  encode_block(v, man + row * nb * smof::kBfp8Block, exp + warp, lane, b);
}

// Mean of rows p[0], p[c], ..., p[(k-1)c], summed in order from 0.
__device__ __forceinline__ float serial_mean(const float* __restrict__ p,
                                             int64_t k, int64_t c) {
  float s = 0.0f;
  for (int64_t j = 0; j < k; ++j) s += p[j * c];
  return s / static_cast<float>(k);
}

__global__ void pool_kernel(const float* __restrict__ x, float* __restrict__ y,
                            int64_t m_out, int64_t k, int64_t c) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= m_out * c) return;
  int64_t o = i / c, ch = i - o * c;
  y[i] = serial_mean(x + o * k * c + ch, k, c);
}

// One pass of the tree: `in` viewed as (g, n, c), `out` as (g, chunks, c)
// with chunks = ceil(n / kPoolChunk); out[o, j] = (sum of rows
// [j kPoolChunk, (j+1) kPoolChunk) of group o) / div.  Block: 8 warps; warp
// r takes rows r, r + 8, ... of the chunk, lane l channel 32 * blockIdx.y + l.
__global__ void __launch_bounds__(kPoolRowLanes * 32)
pool_tree_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int64_t n, int64_t c, int64_t chunks, float div) {
  __shared__ float part[kPoolRowLanes][32];
  const int lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int64_t o = blockIdx.x / chunks, j = blockIdx.x - o * chunks;
  const int64_t ch = (int64_t)blockIdx.y * 32 + lane;
  const int64_t r1 = (j + 1) * kPoolChunk < n ? (j + 1) * kPoolChunk : n;
  float s = 0.0f;
  if (ch < c) {
    const float* p = in + o * n * c + ch;
    for (int64_t r = j * kPoolChunk + rl; r < r1; r += kPoolRowLanes)
      s += p[r * c];
  }
  part[rl][lane] = s;
  __syncthreads();
#pragma unroll
  for (int h = kPoolRowLanes / 2; h > 0; h >>= 1) {
    if (rl < h) part[rl][lane] += part[rl + h][lane];
    __syncthreads();
  }
  if (rl == 0 && ch < c) out[(o * chunks + j) * c + ch] = part[0][lane] / div;
}

// Pool with the egress encode: one warp per (output row, block).
__global__ void pool_encode_kernel(const float* __restrict__ x,
                                   float* __restrict__ y,
                                   int8_t* __restrict__ man,
                                   int8_t* __restrict__ exp, int64_t m_out,
                                   int64_t k, int64_t c, int64_t nb) {
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (warp >= m_out * nb) return;  // whole warps leave together
  int64_t o = warp / nb, b = warp - o * nb;
  int64_t col = b * smof::kBfp8Block + lane;
  float v = 0.0f;
  if (col < c) {
    v = serial_mean(x + o * k * c + col, k, c);
    y[o * c + col] = v;
  }
  encode_block(v, man + o * nb * smof::kBfp8Block, exp + warp, lane, b);
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

// x: (m_out * k, c); y: (m_out, c).  scratch: f32 partial sums for k >
// kPoolSerialMaxK, m_out * (ceil(k / 256) + ceil(k / 65536)) * c values
// when ceil(k / 256) > 1, else unused (kernels/streaming_conv.py sizes it).
extern "C" int smof_pool(const void* x, void* y, void* scratch, int64_t m_out,
                         int64_t k, int64_t c, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m_out * c <= 0) return (int)cudaGetLastError();
  if (k <= kPoolSerialMaxK) {
    pool_kernel<<<grid_for(m_out * c, 256), 256, 0, st>>>(
        (const float*)x, (float*)y, m_out, k, c);
    return (int)cudaGetLastError();
  }
  float* bufs[2] = {(float*)scratch,
                    (float*)scratch +
                        m_out * ((k + kPoolChunk - 1) / kPoolChunk) * c};
  const float* in = (const float*)x;
  int which = 0;
  for (int64_t n = k;;) {
    int64_t chunks = (n + kPoolChunk - 1) / kPoolChunk;
    bool last = chunks == 1;
    float* out = last ? (float*)y : bufs[which];
    dim3 grid((unsigned)(m_out * chunks), (unsigned)((c + 31) / 32));
    pool_tree_kernel<<<grid, kPoolRowLanes * 32, 0, st>>>(
        in, out, n, c, chunks, last ? (float)k : 1.0f);
    int err = (int)cudaGetLastError();
    if (err || last) return err;
    in = out;
    n = chunks;
    which ^= 1;
  }
}

// x: (m_out * k, c); y: (m_out, c); man: (m_out, nb * 32); exp: (m_out, nb).
extern "C" int smof_pool_encode(const void* x, void* y, void* man, void* exp,
                                int64_t m_out, int64_t k, int64_t c,
                                void* stream) {
  int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m_out * nb > 0)
    pool_encode_kernel<<<grid_for(m_out * nb * 32, 256), 256, 0,
                         (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, (int8_t*)man, (int8_t*)exp, m_out, k, c,
        nb);
  return (int)cudaGetLastError();
}
