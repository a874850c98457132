// act_relu and pool: the row-streaming elementwise and pooling kernels, with
// the fused BFP8 boundary codec.
//
// act_relu replaces the TPU kernels _act_kernel, _act_dec_kernel,
// _act_enc_kernel and _act_dec_enc_kernel (src/repro/kernels/
// streaming_conv.py, act_relu); pool
// replaces _pool_kernel, _pool_dec_kernel, _pool_enc_kernel and
// _pool_dec_enc_kernel (same file, pool).  On the H100 all of them are bound
// by bytes: relu does one compare per 8 bytes moved, the egress encode adds a
// 32-lane max and one division per value, the ingress decode one multiply
// per 1 + 1/32 bytes read, and pool one addition per 4 bytes (or per payload
// byte) read.  The designs therefore aim at full-width, coalesced loads and
// stores, and at enough blocks in flight:
//  * act_relu (plain): four values per thread, 16-byte loads and stores;
//    the thread at the end of a ragged n takes the n % 4 left one by one;
//  * act_relu with the ingress decode alone: four channels of a row per
//    thread, one 4-byte load of mantissas (char4; the payload's rows are
//    nb * 32 bytes, so every group of four lies inside the row and inside
//    one 32-channel block, under one exponent) and one 16-byte store where
//    c % 4 == 0; for other c the thread stores its channels below c one by
//    one, so the payload's padding channels never reach y;
//  * act_relu and pool (egress encode, and act_relu's decode -> relu ->
//    encode): one warp per (row, 32-channel block).  Lane l owns channel
//    32*b + l, the block's amax is a butterfly of __shfl_xor_sync, and the
//    f32 output, the mantissas and the block's exponent are written from the
//    same registers, so the payload costs 1 + 1/32 extra bytes per value and
//    no second pass over the output.  With the ingress decode lane l reads
//    mantissa 32*b + l (the warp's 32 bytes are contiguous) and the block's
//    exponent, and decodes them with bfp8_decode (bfp8.cuh), the standalone
//    decode's own arithmetic;
//  * pool over few rows (k <= kPoolSerialMaxK, the 2:1 downsampling): one
//    thread per output value sums its k rows in order (one warp per (row,
//    block) when it also encodes); neighbouring threads take neighbouring
//    channels, so each row read is coalesced;
//  * pool over many rows (the SE global pool, k up to 262144 at few
//    channels): one thread per output would leave the card idle and sum
//    in one long f32 chain.  A tree instead: each block reduces a chunk of
//    kPoolChunk rows for 32 channels (8 warps, each warp one row at a time,
//    lane = channel, then a shared-memory tree over the 8 warps), and the
//    per-chunk sums go through the same kernel again until one row is left.
//    The longest serial chain is kPoolChunk / 8 = 32 additions per pass.
//  * every pool variant runs these same passes: the ingress decode is the
//    input load of the first pass and the egress encode the epilogue of the
//    last (whose warp 0 holds one output row's 32-channel block), so y is
//    bit for bit the plain pool kernel's on the decoded input, at every k.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

using smof::Stripe;

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

// Four channels 4q .. 4q + 3 of row r per thread, q < q4 = ceil(c / 4):
// y[r, ch] = relu(man[r, ch] * 2^(exp[r, ch / 32] - 6)) for ch < c.
__global__ void act_relu_decode_kernel(const int8_t* __restrict__ man,
                                       const int8_t* __restrict__ exp,
                                       float* __restrict__ y, int64_t m,
                                       int64_t c, int64_t nb, int64_t q4) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= m * q4) return;
  int64_t r = i / q4, ch = (i - r * q4) * 4;
  const char4 mv =
      *reinterpret_cast<const char4*>(man + r * nb * smof::kBfp8Block + ch);
  const int8_t e = exp[r * nb + ch / smof::kBfp8Block];
  const float v[4] = {relu(smof::bfp8_decode(mv.x, e)),
                      relu(smof::bfp8_decode(mv.y, e)),
                      relu(smof::bfp8_decode(mv.z, e)),
                      relu(smof::bfp8_decode(mv.w, e))};
  float* out = y + r * c + ch;
  if ((c & 3) == 0) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ch + j < c) out[j] = v[j];
  }
}

// One warp per (row, block) of an (m, c) input; the payload has nb blocks a
// row.
template <bool kDecode>
__global__ void act_relu_encode_kernel(Stripe<kDecode> in,
                                       float* __restrict__ y,
                                       int8_t* __restrict__ man,
                                       int8_t* __restrict__ exp, int64_t m,
                                       int64_t nb) {
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (warp >= m * nb) return;  // whole warps leave together
  int64_t row = warp / nb, b = warp - row * nb;
  int64_t col = b * smof::kBfp8Block + lane;
  float v = 0.0f;
  if (col < in.c) {
    v = relu(in.at(row, col));
    y[row * in.c + col] = v;
  }
  smof::bfp8_encode_warp(v, man + warp * smof::kBfp8Block, exp + warp, lane);
}

// Mean of rows o k .. o k + k - 1 of channel ch, summed in order from 0.
template <bool kDecode>
__device__ __forceinline__ float serial_mean(const Stripe<kDecode>& in,
                                             int64_t o, int64_t k,
                                             int64_t ch) {
  float s = 0.0f;
  for (int64_t j = 0; j < k; ++j) s += in.at(o * k + j, ch);
  return s / static_cast<float>(k);
}

template <bool kDecode>
__global__ void pool_kernel(Stripe<kDecode> in, float* __restrict__ y,
                            int64_t m_out, int64_t k) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= m_out * in.c) return;
  int64_t o = i / in.c, ch = i - o * in.c;
  y[i] = serial_mean(in, o, k, ch);
}

// Pool with the egress encode: one warp per (output row, block).
template <bool kDecode>
__global__ void pool_encode_kernel(Stripe<kDecode> in, float* __restrict__ y,
                                   int8_t* __restrict__ man,
                                   int8_t* __restrict__ exp, int64_t m_out,
                                   int64_t k, int64_t nb) {
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (warp >= m_out * nb) return;  // whole warps leave together
  int64_t o = warp / nb, b = warp - o * nb;
  int64_t col = b * smof::kBfp8Block + lane;
  float v = 0.0f;
  if (col < in.c) {
    v = serial_mean(in, o, k, col);
    y[o * in.c + col] = v;
  }
  smof::bfp8_encode_warp(v, man + warp * smof::kBfp8Block, exp + warp, lane);
}

// One pass of the tree: `in` viewed as (g, n, c), `out` as (g, chunks, c)
// with chunks = ceil(n / kPoolChunk); out[o, j] = (sum of rows
// [j kPoolChunk, (j+1) kPoolChunk) of group o) / div.  Block: 8 warps; warp
// r takes rows r, r + 8, ... of the chunk, lane l channel 32 * blockIdx.y + l.
// kEncode (the last pass, chunks == 1): warp 0 also writes the payload of
// its output row's block blockIdx.y.
template <bool kDecode, bool kEncode>
__global__ void __launch_bounds__(kPoolRowLanes * 32)
pool_tree_kernel(Stripe<kDecode> in, float* __restrict__ out,
                 int8_t* __restrict__ man, int8_t* __restrict__ exp,
                 int64_t n, int64_t chunks, float div) {
  __shared__ float part[kPoolRowLanes][32];
  const int lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int64_t o = blockIdx.x / chunks, j = blockIdx.x - o * chunks;
  const int64_t ch = (int64_t)blockIdx.y * 32 + lane;
  const int64_t r1 = (j + 1) * kPoolChunk < n ? (j + 1) * kPoolChunk : n;
  float s = 0.0f;
  if (ch < in.c)
    for (int64_t r = j * kPoolChunk + rl; r < r1; r += kPoolRowLanes)
      s += in.at(o * n + r, ch);
  part[rl][lane] = s;
  __syncthreads();
#pragma unroll
  for (int h = kPoolRowLanes / 2; h > 0; h >>= 1) {
    if (rl < h) part[rl][lane] += part[rl + h][lane];
    __syncthreads();
  }
  if (rl != 0) return;  // whole warps leave together
  const float v = ch < in.c ? part[0][lane] / div : 0.0f;
  if (ch < in.c) out[(o * chunks + j) * in.c + ch] = v;
  if constexpr (kEncode) {
    const int64_t nb = gridDim.y, b = blockIdx.y;
    smof::bfp8_encode_warp(v, man + (o * nb + b) * smof::kBfp8Block,
                           exp + o * nb + b, lane);
  }
}

unsigned grid_for(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

// One tree pass from `in` into `out`; the encode only where `last`.
template <bool kDecode, bool kEncode>
int tree_pass(Stripe<kDecode> in, float* out, int8_t* man, int8_t* exp,
              int64_t m_out, int64_t n, int64_t chunks, bool last, float k,
              cudaStream_t st) {
  const dim3 grid((unsigned)(m_out * chunks),
                  (unsigned)((in.c + 31) / 32));
  if (last)
    pool_tree_kernel<kDecode, kEncode><<<grid, kPoolRowLanes * 32, 0, st>>>(
        in, out, man, exp, n, chunks, k);
  else
    pool_tree_kernel<kDecode, false><<<grid, kPoolRowLanes * 32, 0, st>>>(
        in, out, nullptr, nullptr, n, chunks, 1.0f);
  return (int)cudaGetLastError();
}

// Every pool variant: in (m_out * k, c) -> y (m_out, c), with kEncode the
// payload man (m_out, nb * 32), exp (m_out, nb).  scratch: f32 partial sums
// for k > kPoolSerialMaxK, m_out * (ceil(k / 256) + ceil(k / 65536)) * c
// values when ceil(k / 256) > 1, else unused (kernels/streaming_conv.py
// sizes it).
template <bool kDecode, bool kEncode>
int run_pool(Stripe<kDecode> in, float* y, int8_t* man, int8_t* exp,
             float* scratch, int64_t m_out, int64_t k, cudaStream_t st) {
  const int64_t c = in.c;
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m_out * c <= 0) return (int)cudaGetLastError();
  if (k <= kPoolSerialMaxK) {
    if constexpr (kEncode)
      pool_encode_kernel<kDecode><<<grid_for(m_out * nb * 32, 256), 256, 0,
                                    st>>>(in, y, man, exp, m_out, k, nb);
    else
      pool_kernel<kDecode><<<grid_for(m_out * c, 256), 256, 0, st>>>(
          in, y, m_out, k);
    return (int)cudaGetLastError();
  }
  float* bufs[2] = {scratch,
                    scratch + m_out * ((k + kPoolChunk - 1) / kPoolChunk) * c};
  // the first pass reads `in` (decoding it), every later one a buffer
  int64_t chunks = (k + kPoolChunk - 1) / kPoolChunk;
  bool last = chunks == 1;
  float* out = last ? y : bufs[0];
  int err = tree_pass<kDecode, kEncode>(in, out, man, exp, m_out, k, chunks,
                                        last, (float)k, st);
  Stripe<false> mid = smof::f32_stripe(out, c);
  for (int which = 1; !err && !last; which ^= 1) {
    const int64_t n = chunks;
    chunks = (n + kPoolChunk - 1) / kPoolChunk;
    last = chunks == 1;
    out = last ? y : bufs[which];
    err = tree_pass<false, kEncode>(mid, out, man, exp, m_out, n, chunks,
                                    last, (float)k, st);
    mid.x = out;
  }
  return err;
}

// One warp per (row, block) of an (m, c) output: payload nb * 32 wide.
template <bool kDecode>
int run_act_relu_encode(Stripe<kDecode> in, void* y, void* man, void* exp,
                        int64_t m, cudaStream_t st) {
  const int64_t nb = (in.c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m * nb > 0)
    act_relu_encode_kernel<kDecode><<<grid_for(m * nb * 32, 256), 256, 0,
                                      st>>>(in, (float*)y, (int8_t*)man,
                                            (int8_t*)exp, m, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int smof_act_relu(const void* x, void* y, int64_t n, void* stream) {
  if (n > 0)
    act_relu_kernel<<<grid_for((n + 3) / 4, 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

// man: (m, nb * 32), 4-byte aligned; exp: (m, nb); y: (m, c);
// nb = ceil(c / 32).
extern "C" int smof_act_relu_decode(const void* man, const void* exp, void* y,
                                    int64_t m, int64_t c, void* stream) {
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  const int64_t q4 = (c + 3) / 4;
  if (m * q4 > 0)
    act_relu_decode_kernel<<<grid_for(m * q4, 256), 256, 0,
                             (cudaStream_t)stream>>>(
        (const int8_t*)man, (const int8_t*)exp, (float*)y, m, c, nb, q4);
  return (int)cudaGetLastError();
}

// x, y: (m, c); man: (m, nb * 32); exp: (m, nb); nb = ceil(c / 32).
extern "C" int smof_act_relu_encode(const void* x, void* y, void* man,
                                    void* exp, int64_t m, int64_t c,
                                    void* stream) {
  return run_act_relu_encode(smof::f32_stripe(x, c), y, man, exp, m,
                             (cudaStream_t)stream);
}

// xman, man: (m, nb * 32); xexp, exp: (m, nb); y: (m, c).
extern "C" int smof_act_relu_decode_encode(const void* xman, const void* xexp,
                                           void* y, void* man, void* exp,
                                           int64_t m, int64_t c,
                                           void* stream) {
  return run_act_relu_encode(smof::payload_stripe(xman, xexp, c), y, man,
                             exp, m, (cudaStream_t)stream);
}

// x: (m_out * k, c); y: (m_out, c); scratch as run_pool says.
extern "C" int smof_pool(const void* x, void* y, void* scratch, int64_t m_out,
                         int64_t k, int64_t c, void* stream) {
  return run_pool<false, false>(smof::f32_stripe(x, c), (float*)y, nullptr,
                                nullptr, (float*)scratch, m_out, k,
                                (cudaStream_t)stream);
}

// ... and man: (m_out, nb * 32); exp: (m_out, nb).
extern "C" int smof_pool_encode(const void* x, void* y, void* man, void* exp,
                                void* scratch, int64_t m_out, int64_t k,
                                int64_t c, void* stream) {
  return run_pool<false, true>(smof::f32_stripe(x, c), (float*)y,
                               (int8_t*)man, (int8_t*)exp, (float*)scratch,
                               m_out, k, (cudaStream_t)stream);
}

// xman: (m_out * k, nb * 32); xexp: (m_out * k, nb); y: (m_out, c).
extern "C" int smof_pool_decode(const void* xman, const void* xexp, void* y,
                                void* scratch, int64_t m_out, int64_t k,
                                int64_t c, void* stream) {
  return run_pool<true, false>(smof::payload_stripe(xman, xexp, c), (float*)y,
                               nullptr, nullptr, (float*)scratch, m_out, k,
                               (cudaStream_t)stream);
}

extern "C" int smof_pool_decode_encode(const void* xman, const void* xexp,
                                       void* y, void* man, void* exp,
                                       void* scratch, int64_t m_out,
                                       int64_t k, int64_t c, void* stream) {
  return run_pool<true, true>(smof::payload_stripe(xman, xexp, c), (float*)y,
                              (int8_t*)man, (int8_t*)exp, (float*)scratch,
                              m_out, k, (cudaStream_t)stream);
}
