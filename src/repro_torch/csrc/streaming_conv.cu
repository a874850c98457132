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
//  * act_relu (plain): kActUnroll 16-byte loads in flight a thread (64
//    bytes), one pass of a grid that covers each row block; the fewer than
//    4 values at either end of a row block that no aligned float4 holds
//    are taken one by one.  A grid capped to the blocks the SMs hold (each
//    block walking the rest) and __ldcs / __stcs streaming hints were each
//    slower than this on the H100, and torch.relu was level with it;
//  * act_relu with the ingress decode alone: four channels of a row per
//    thread, one 4-byte load of mantissas (char4; the payload's rows are
//    nb * 32 bytes, so every group of four lies inside the row and inside
//    one 32-channel block, under one exponent) and one 16-byte store where
//    c % 4 == 0; for other c the thread stores its channels below c one by
//    one, so the payload's padding channels never reach y;
//  * act_relu with the egress encode, and its decode -> relu -> encode:
//    kActLanes = 8 lanes per (row, 32-channel block), 4 channels a lane, so
//    a warp covers four blocks.  A lane makes one 16-byte load (with the
//    decode one char4 of mantissas and the block's exponent, decoded with
//    bfp8_decode, the standalone decode's arithmetic), the block's amax
//    comes from the lane's 4 values and 3 shuffle steps
//    (smof::bfp8_encode_group), and the lane stores one float4 of y and
//    one char4 of mantissas, the group's first lane the exponent.  The
//    payload costs 1 + 1/32 extra bytes per value and no second pass over
//    the output.  Where c % 4 != 0 (or an input is not aligned for the
//    wide access) a lane takes its channels one by one, and only those
//    below c reach y;
//  * pool with the egress encode: one warp per (row, 32-channel block),
//    lane l channel 32*b + l, the block's amax a butterfly of
//    __shfl_xor_sync (bfp8_encode_warp);
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
//
// Tiles (the plan's tile_bm, the reference's bm): every act_relu variant,
// and pool over few rows, cut their output rows into row blocks of bm rows,
// grid row y for block y, and the grid's x blocks share one row block's
// work (RowTiles).  bm 0 is one row block of all m rows, the untiled launch;
// a bm that would need more than 65535 row blocks grows to ceil(m / 65535).
// The tree passes of pool over many rows give each block one output row's
// chunk whatever bm is.  Every output is computed by the same arithmetic
// whatever the tile, so no tile changes a result.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

using smof::Stripe;

constexpr int64_t kPoolSerialMaxK = 8;
constexpr int64_t kPoolChunk = 256;
constexpr int kPoolRowLanes = 8;  // warps of a tree block

// Row blocks of rb rows, n of them (grid y), for m rows and the plan's bm.
struct RowTiles {
  int64_t rb;
  unsigned n;
};

RowTiles row_tiles(int64_t m, int64_t bm) {
  int64_t rb = bm > 0 ? bm : (m > 0 ? m : 1);
  if ((m + rb - 1) / rb > 65535) rb = (m + 65534) / 65535;
  return {rb, (unsigned)((m + rb - 1) / rb)};
}

// Rows of this block's row block: [*r0, *r0 + return value).
__device__ __forceinline__ int64_t block_rows(int64_t m, int64_t rb,
                                              int64_t* r0) {
  *r0 = (int64_t)blockIdx.y * rb;
  return m - *r0 < rb ? m - *r0 : rb;
}

// relu as the plain version computes it (torch.where(x < 0, 0, x)): NaN
// and -0.0 pass through unchanged.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

constexpr int kActThreads = 256;
constexpr int kActUnroll = 4;  // float4s in flight a thread
constexpr int kActLanes = 8;   // lanes of one (row, block) in the encodes

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
}

// Row block blockIdx.y: its whole aligned float4s (x and y are 16-byte
// aligned), kActUnroll a thread over the grid's x blocks, and the fewer
// than 4 values at either end one by one.
__global__ void __launch_bounds__(kActThreads)
act_relu_kernel(const float* __restrict__ x, float* __restrict__ y,
                int64_t m, int64_t c, int64_t rb) {
  int64_t r0;
  const int64_t rows = block_rows(m, rb, &r0);
  const int64_t begin = r0 * c, end = begin + rows * c;
  const int64_t q0 = (begin + 3) / 4, q1 = end / 4;  // float4s [q0, q1)
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int j = threadIdx.x & 3;
    const int64_t i = threadIdx.x < 4 ? begin + j : 4 * q1 + j;
    const int64_t lo = threadIdx.x < 4 ? begin : (q1 > q0 ? 4 * q1 : 4 * q0);
    const int64_t hi = threadIdx.x < 4 ? (4 * q0 < end ? 4 * q0 : end) : end;
    if (i >= lo && i < hi) y[i] = relu(x[i]);
  }
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const int64_t q =
      q0 + (int64_t)blockIdx.x * kActThreads * kActUnroll + threadIdx.x;
  float4 v[kActUnroll];
#pragma unroll
  for (int u = 0; u < kActUnroll; ++u)
    if (q + u * kActThreads < q1) v[u] = x4[q + u * kActThreads];
#pragma unroll
  for (int u = 0; u < kActUnroll; ++u)
    if (q + u * kActThreads < q1) y4[q + u * kActThreads] = relu4(v[u]);
}

// Four channels 4q .. 4q + 3 of row r per thread, q < q4 = ceil(c / 4):
// y[r, ch] = relu(man[r, ch] * 2^(exp[r, ch / 32] - 6)) for ch < c.
__global__ void act_relu_decode_kernel(const int8_t* __restrict__ man,
                                       const int8_t* __restrict__ exp,
                                       float* __restrict__ y, int64_t m,
                                       int64_t c, int64_t nb, int64_t q4,
                                       int64_t rb) {
  int64_t r0;
  const int64_t rows = block_rows(m, rb, &r0);
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows * q4) return;
  i += r0 * q4;
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

// kActLanes lanes per (row, block) of an (m, c) input, channels 4 sub ..
// 4 sub + 3 of the block in lane sub; the payload has nb blocks a row.
// in_vec: the input's rows may be read 16 bytes (f32) or 4 bytes (the
// mantissas) at a time; c4: c % 4 == 0, so y's rows take float4 stores.
template <bool kDecode>
__global__ void __launch_bounds__(256)
act_relu_encode_kernel(Stripe<kDecode> in, float* __restrict__ y,
                       int8_t* __restrict__ man, int8_t* __restrict__ exp,
                       int64_t m, int64_t nb, int64_t rb, bool in_vec,
                       bool c4) {
  int64_t r0;
  const int64_t rows = block_rows(m, rb, &r0);
  const int64_t gid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t pairs = rows * nb;
  // whole warps leave together; a warp's groups past the end encode zeros
  if (gid / 32 * (32 / kActLanes) >= pairs) return;
  const int sub = threadIdx.x % kActLanes;
  const bool live = gid / kActLanes < pairs;
  const int64_t pair = gid / kActLanes + r0 * nb;
  const int64_t row = pair / nb, b = pair - row * nb, c = in.c;
  const int64_t ch = b * smof::kBfp8Block + sub * 4;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    if constexpr (kDecode) {
      const int8_t* mp = in.man + row * nb * smof::kBfp8Block + ch;
      const float scale = smof::bfp8_scale(in.exp[pair]);
      int8_t q[4];
      if (in_vec) {
        const char4 mv = *reinterpret_cast<const char4*>(mp);
        q[0] = mv.x, q[1] = mv.y, q[2] = mv.z, q[3] = mv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = mp[j];
      }
      // the payload's padding channels never reach y
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < c) v[j] = relu(smof::bfp8_decode_scaled(q[j], scale));
    } else if (in_vec && c4) {
      if (ch < c) {
        const float4 xv =
            *reinterpret_cast<const float4*>(in.x + row * c + ch);
        v[0] = relu(xv.x), v[1] = relu(xv.y), v[2] = relu(xv.z),
        v[3] = relu(xv.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < c) v[j] = relu(in.x[row * c + ch + j]);
    }
  }
  int8_t q[4];
  const int e = smof::bfp8_encode_group<kActLanes, 4>(v, q);
  if (!live) return;
  float* out = y + row * c + ch;
  if (c4) {
    if (ch < c) *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1],
                                                              v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ch + j < c) out[j] = v[j];
  }
  *reinterpret_cast<char4*>(man + pair * smof::kBfp8Block + sub * 4) =
      make_char4(q[0], q[1], q[2], q[3]);
  if (sub == 0) exp[pair] = static_cast<int8_t>(e);
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
                            int64_t m_out, int64_t k, int64_t rb) {
  int64_t r0;
  const int64_t rows = block_rows(m_out, rb, &r0);
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows * in.c) return;
  i += r0 * in.c;
  int64_t o = i / in.c, ch = i - o * in.c;
  y[i] = serial_mean(in, o, k, ch);
}

// Pool with the egress encode: one warp per (output row, block).
template <bool kDecode>
__global__ void pool_encode_kernel(Stripe<kDecode> in, float* __restrict__ y,
                                   int8_t* __restrict__ man,
                                   int8_t* __restrict__ exp, int64_t m_out,
                                   int64_t k, int64_t nb, int64_t rb) {
  int64_t r0;
  const int64_t rows = block_rows(m_out, rb, &r0);
  int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  if (warp >= rows * nb) return;  // whole warps leave together
  warp += r0 * nb;
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
             float* scratch, int64_t m_out, int64_t k, int64_t bm,
             cudaStream_t st) {
  const int64_t c = in.c;
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m_out * c <= 0) return (int)cudaGetLastError();
  if (k <= kPoolSerialMaxK) {
    const RowTiles t = row_tiles(m_out, bm);
    if constexpr (kEncode)
      pool_encode_kernel<kDecode><<<dim3(grid_for(t.rb * nb * 32, 256), t.n),
                                    256, 0, st>>>(in, y, man, exp, m_out, k,
                                                  nb, t.rb);
    else
      pool_kernel<kDecode><<<dim3(grid_for(t.rb * c, 256), t.n), 256, 0,
                             st>>>(in, y, m_out, k, t.rb);
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

// kActLanes lanes per (row, block) of an (m, c) output: payload nb * 32
// wide.
template <bool kDecode>
int run_act_relu_encode(Stripe<kDecode> in, void* y, void* man, void* exp,
                        int64_t m, int64_t bm, cudaStream_t st) {
  const int64_t nb = (in.c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m * nb > 0) {
    const RowTiles t = row_tiles(m, bm);
    const bool in_vec = kDecode ? aligned(in.man, 4) : aligned(in.x, 16);
    act_relu_encode_kernel<kDecode><<<dim3(grid_for(t.rb * nb * kActLanes,
                                                    256), t.n), 256, 0, st>>>(
        in, (float*)y, (int8_t*)man, (int8_t*)exp, m, nb, t.rb, in_vec,
        in.c % 4 == 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (m, c), 16-byte aligned; bm: the row tile (every entry point).
extern "C" int smof_act_relu(const void* x, void* y, int64_t m, int64_t c,
                             int64_t bm, void* stream) {
  if (m * c > 0) {
    const RowTiles t = row_tiles(m, bm);
    // a row block holds at most rb c / 4 whole float4s
    const unsigned bx = grid_for(t.rb * c / 4, kActThreads * kActUnroll);
    act_relu_kernel<<<dim3(bx > 0 ? bx : 1, t.n), kActThreads, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, m,
                                              c, t.rb);
  }
  return (int)cudaGetLastError();
}

// man: (m, nb * 32), 4-byte aligned; exp: (m, nb); y: (m, c);
// nb = ceil(c / 32).
extern "C" int smof_act_relu_decode(const void* man, const void* exp, void* y,
                                    int64_t m, int64_t c, int64_t bm,
                                    void* stream) {
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  const int64_t q4 = (c + 3) / 4;
  if (m * q4 > 0) {
    const RowTiles t = row_tiles(m, bm);
    act_relu_decode_kernel<<<dim3(grid_for(t.rb * q4, 256), t.n), 256, 0,
                             (cudaStream_t)stream>>>(
        (const int8_t*)man, (const int8_t*)exp, (float*)y, m, c, nb, q4,
        t.rb);
  }
  return (int)cudaGetLastError();
}

// x, y: (m, c); man: (m, nb * 32); exp: (m, nb); nb = ceil(c / 32).
extern "C" int smof_act_relu_encode(const void* x, void* y, void* man,
                                    void* exp, int64_t m, int64_t c,
                                    int64_t bm, void* stream) {
  return run_act_relu_encode(smof::f32_stripe(x, c), y, man, exp, m, bm,
                             (cudaStream_t)stream);
}

// xman, man: (m, nb * 32); xexp, exp: (m, nb); y: (m, c).
extern "C" int smof_act_relu_decode_encode(const void* xman, const void* xexp,
                                           void* y, void* man, void* exp,
                                           int64_t m, int64_t c, int64_t bm,
                                           void* stream) {
  return run_act_relu_encode(smof::payload_stripe(xman, xexp, c), y, man,
                             exp, m, bm, (cudaStream_t)stream);
}

// x: (m_out * k, c); y: (m_out, c); scratch as run_pool says.
extern "C" int smof_pool(const void* x, void* y, void* scratch, int64_t m_out,
                         int64_t k, int64_t c, int64_t bm, void* stream) {
  return run_pool<false, false>(smof::f32_stripe(x, c), (float*)y, nullptr,
                                nullptr, (float*)scratch, m_out, k, bm,
                                (cudaStream_t)stream);
}

// ... and man: (m_out, nb * 32); exp: (m_out, nb).
extern "C" int smof_pool_encode(const void* x, void* y, void* man, void* exp,
                                void* scratch, int64_t m_out, int64_t k,
                                int64_t c, int64_t bm, void* stream) {
  return run_pool<false, true>(smof::f32_stripe(x, c), (float*)y,
                               (int8_t*)man, (int8_t*)exp, (float*)scratch,
                               m_out, k, bm, (cudaStream_t)stream);
}

// xman: (m_out * k, nb * 32); xexp: (m_out * k, nb); y: (m_out, c).
extern "C" int smof_pool_decode(const void* xman, const void* xexp, void* y,
                                void* scratch, int64_t m_out, int64_t k,
                                int64_t c, int64_t bm, void* stream) {
  return run_pool<true, false>(smof::payload_stripe(xman, xexp, c), (float*)y,
                               nullptr, nullptr, (float*)scratch, m_out, k,
                               bm, (cudaStream_t)stream);
}

extern "C" int smof_pool_decode_encode(const void* xman, const void* xexp,
                                       void* y, void* man, void* exp,
                                       void* scratch, int64_t m_out,
                                       int64_t k, int64_t c, int64_t bm,
                                       void* stream) {
  return run_pool<true, true>(smof::payload_stripe(xman, xexp, c), (float*)y,
                              (int8_t*)man, (int8_t*)exp, (float*)scratch,
                              m_out, k, bm, (cudaStream_t)stream);
}
