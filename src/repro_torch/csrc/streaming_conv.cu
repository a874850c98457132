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
// stores, enough bytes in flight a thread, and one scale per codec block:
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
//  * every pool variant reads its input a quad (4 channels of a row) at a
//    time through Stripe::quad (bfp8.cuh): one 16-byte load of x, or one
//    char4 of mantissas and one scale for the four values with the decode,
//    where c % 4 == 0 and the input is aligned for it; else the quad's
//    channels below c one by one (the same sums either way).  The payload's
//    padding channels are never read;
//  * pool over few rows (k <= kPoolSerialMaxK, the 2:1 downsampling of
//    every YOLO, UNet and X3D stage): a thread owns kPoolUnroll output
//    quads, kPoolThreads apart, and keeps their k loads in flight (all
//    2 * kPoolUnroll 16-byte loads, 64 bytes, at k = 2), then sums each
//    channel in order from 0, ((0 + x_0) + x_1) ... + x_{k-1}, and divides
//    by k: at k = 2 bit for bit the plain mean, and every codec variant bit
//    for bit this kernel on the decoded input.  Offsets inside a row block
//    are 32-bit.  With the egress encode, kActLanes lanes per (row,
//    block) as for act_relu.  This replaces one thread per output value
//    (two 4-byte loads and a 64-bit division each) and, for the encode,
//    one warp per (row, block) with byte stores;
//  * pool over many rows (the SE global pool, k up to 262144 at few
//    channels): one launch, where a tree of passes took up to three.  A
//    block sums a
//    chunk of lanes * kPoolLaneRows rows of one output row's channel tile
//    (tq <= kPoolTileQuads quads): thread (lane, quad) takes rows lane,
//    lane + lanes, ..., kPoolInFlight loads in flight, so at c < 32 a warp
//    still covers whole rows (several rows a warp), and the block adds its
//    lanes in a fixed tree; the last block of an output row to finish sums
//    the chunks' partials the same way and writes y (and the payload).  The
//    longest serial chain is kPoolLaneRows additions plus the chunks a lane
//    takes in the last block.  The sum order depends on (k, c) alone, so
//    two launches, every bm, alignment and codec variant give the same
//    bits; it differs from the plain mean's within POOL_TOL.
//
// Tiles (the plan's tile_bm, the reference's bm): every act_relu variant,
// and pool over few rows, cut their output rows into row blocks of bm rows,
// grid row y for block y, and the grid's x blocks share one row block's
// work (RowTiles).  bm 0 is one row block of all m rows, the untiled launch;
// a bm that would need more than 65535 row blocks grows to ceil(m / 65535).
// Pool over many rows gives each block one output row's chunk whatever bm
// is.  Every output is computed by the same arithmetic whatever the tile,
// so no tile changes a result.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

using smof::Stripe;

constexpr int kPoolThreads = 256;
constexpr int64_t kPoolSerialMaxK = 8;
constexpr int kPoolUnroll = 2;      // output quads a thread, k <= 8
constexpr int kPoolLaneRows = 32;   // rows a lane sums in one chunk, k > 8
constexpr int kPoolInFlight = 8;    // loads a lane starts before adding
constexpr int kPoolTileQuads = 64;  // quads of a channel tile, k > 8
constexpr int kPoolTreeBlocks = 4;  // blocks an SM holds, k > 8

// Row blocks of rb rows, n of them (grid y), for m rows and the plan's bm;
// rb at most max_rb.
struct RowTiles {
  int64_t rb;
  unsigned n;
};

RowTiles row_tiles(int64_t m, int64_t bm, int64_t max_rb = INT64_MAX) {
  int64_t rb = bm > 0 ? bm : (m > 0 ? m : 1);
  if (rb > max_rb) rb = max_rb > 0 ? max_rb : 1;
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

unsigned grid_for(int64_t work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// -- pool ---------------------------------------------------------------------

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 div4(float4 a, float k) {
  return make_float4(a.x / k, a.y / k, a.z / k, a.w / k);
}

// Channels ch .. ch + 3 of an f32 row at out: one 16-byte store where
// c % 4 == 0 (c4; out is then 16-byte aligned), else those below c one by
// one.
__device__ __forceinline__ void store_quad(float* out, float4 v, int ch,
                                           int c, bool c4) {
  if (ch >= c) return;
  if (c4) {
    *reinterpret_cast<float4*>(out) = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ch + j < c) out[j] = w[j];
}

// Pool over k <= kPoolSerialMaxK rows, every output channel summed in
// order from 0, ((0 + x_0) + x_1) ... + x_{k-1}, then divided by k.  Row
// block blockIdx.y; a thread takes kPoolUnroll quads (4 channels of an
// output row) kPoolThreads apart, so a warp's loads of one input row are
// contiguous.  kK = 2 starts all 2 * kPoolUnroll loads before the first
// addition; kK = 0 takes any k, kPoolUnroll loads in flight a row.
template <bool kDecode, int kK>
__global__ void __launch_bounds__(kPoolThreads)
pool_rows_kernel(Stripe<kDecode> in, float* __restrict__ y, int64_t m_out,
                 int k, int64_t rb, bool vec) {
  int64_t r0;
  const int rows = (int)block_rows(m_out, rb, &r0);
  const int c = (int)in.c, q4 = (c + 3) >> 2, n = rows * q4;
  const Stripe<kDecode> s = in.from_row(r0 * k);
  float* yb = y + r0 * c;
  const int i0 = blockIdx.x * (kPoolThreads * kPoolUnroll) + threadIdx.x;
  int row[kPoolUnroll], ch[kPoolUnroll];
  float4 acc[kPoolUnroll];
#pragma unroll
  for (int u = 0; u < kPoolUnroll; ++u) {
    const int i = i0 + u * kPoolThreads;
    row[u] = i / q4;
    ch[u] = (i - row[u] * q4) * 4;
    acc[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if constexpr (kK > 0) {
    float4 v[kK][kPoolUnroll];
#pragma unroll
    for (int j = 0; j < kK; ++j)
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u)
        v[j][u] = i0 + u * kPoolThreads < n
                        ? s.quad(row[u] * kK + j, ch[u], vec)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kK; ++j)
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) acc[u] = add4(acc[u], v[j][u]);
  } else {
    for (int j = 0; j < k; ++j) {
      float4 v[kPoolUnroll];
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u)
        v[u] = i0 + u * kPoolThreads < n
                   ? s.quad(row[u] * k + j, ch[u], vec)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) acc[u] = add4(acc[u], v[u]);
    }
  }
  const float kf = static_cast<float>(kK > 0 ? kK : k);
#pragma unroll
  for (int u = 0; u < kPoolUnroll; ++u)
    if (i0 + u * kPoolThreads < n)
      store_quad(yb + row[u] * c + ch[u], div4(acc[u], kf), ch[u], c,
                 (c & 3) == 0);
}

// The same pool with the egress encode: kActLanes lanes per (output row,
// 32-channel block), 4 channels a lane (the act_relu encode's scheme); the
// block's amax from the lane's 4 means and 3 shuffle steps; one float4 of
// y, one char4 of mantissas a lane, the group's first lane the exponent.
template <bool kDecode, int kK>
__global__ void __launch_bounds__(kPoolThreads)
pool_rows_encode_kernel(Stripe<kDecode> in, float* __restrict__ y,
                        int8_t* __restrict__ man, int8_t* __restrict__ exp,
                        int64_t m_out, int k, int64_t rb, bool vec) {
  int64_t r0;
  const int rows = (int)block_rows(m_out, rb, &r0);
  const int c = (int)in.c, nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  const int pairs = rows * nb;
  const int gid = blockIdx.x * kPoolThreads + threadIdx.x;
  // whole warps leave together; a warp's groups past the end encode zeros
  if (gid / 32 * (32 / kActLanes) >= pairs) return;
  const int sub = threadIdx.x % kActLanes, pair = gid / kActLanes;
  const bool live = pair < pairs;
  const int row = pair / nb, ch = (pair - row * nb) * smof::kBfp8Block +
                                  sub * 4;
  const Stripe<kDecode> s = in.from_row(r0 * k);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    const int kk = kK > 0 ? kK : k;
    if constexpr (kK > 0) {
      float4 v[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) v[j] = s.quad(row * kK + j, ch, vec);
#pragma unroll
      for (int j = 0; j < kK; ++j) acc = add4(acc, v[j]);
    } else {
      for (int j = 0; j < kk; ++j) acc = add4(acc, s.quad(row * kk + j, ch,
                                                          vec));
    }
    acc = div4(acc, static_cast<float>(kk));
  }
  float v[4] = {acc.x, acc.y, acc.z, acc.w};
  int8_t q[4];
  const int e = smof::bfp8_encode_group<kActLanes, 4>(v, q);
  if (!live) return;
  store_quad(y + (r0 + row) * c + ch, acc, ch, c, (c & 3) == 0);
  const int64_t at = r0 * nb + pair;
  *reinterpret_cast<char4*>(man + at * smof::kBfp8Block + sub * 4) =
      make_char4(q[0], q[1], q[2], q[3]);
  if (sub == 0) exp[at] = static_cast<int8_t>(e);
}

// The pool over k > kPoolSerialMaxK rows (the SE global pool) as one
// launch.  Block (chunk j of output row o, channel tile t): thread
// (lane = threadIdx.x / tq, quad u = threadIdx.x % tq) sums rows lane,
// lane + lanes, ... of the chunk in order (kPoolInFlight loads started
// before their additions), and the block adds its lanes' sums in a fixed
// tree.  With one chunk that is the output row's sum.  Else each block
// writes its sum to `partial` (m_out, chunks, c), and the last block of
// (o, t) to finish sums the chunks' partials the same way, lane l chunks
// l, l + lanes, ..., in a fixed order whatever block is last.  It finds
// itself last by a counter of (o, t) that the wrapper keeps zeroed between
// launches (kernels/streaming_conv.py, _counter_buffer): every block adds
// one, and the last sets it back to 0.  So the sum order depends on
// (k, c) alone: not on bm, on alignment or on the codec variant.
struct PoolLayout {
  int tiles, tq, lanes;   // channel tiles of tq quads; row lanes a block
  int64_t chunk, chunks;  // input rows a block; blocks an output row
};

__host__ __device__ PoolLayout pool_layout(int64_t k, int64_t c) {
  const int64_t q4 = (c + 3) / 4;
  const int64_t tiles = (q4 + kPoolTileQuads - 1) / kPoolTileQuads;
  int64_t tq = (q4 + tiles - 1) / tiles;
  if (tiles > 1) tq = (tq + 7) / 8 * 8;  // a tile holds whole codec blocks
  const int lanes = kPoolThreads / (int)tq;
  const int64_t chunk = (int64_t)lanes * kPoolLaneRows;
  return {(int)tiles, (int)tq, lanes, chunk, (k + chunk - 1) / chunk};
}

// The block's sum of rows [0, n) through load(row) into part[u], u < tq,
// as the layout above says.
template <typename Load>
__device__ __forceinline__ void pool_block_sum(const Load& load, int64_t n,
                                               int tq, int lanes,
                                               float4* part) {
  const int lane = threadIdx.x / tq;
  if (lane < lanes) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int r = lane;
    for (; r + (kPoolInFlight - 1) * lanes < n; r += kPoolInFlight * lanes) {
      float4 v[kPoolInFlight];
#pragma unroll
      for (int i = 0; i < kPoolInFlight; ++i) v[i] = load(r + i * lanes);
#pragma unroll
      for (int i = 0; i < kPoolInFlight; ++i) s = add4(s, v[i]);
    }
    for (; r < n; r += lanes) s = add4(s, load(r));
    part[threadIdx.x] = s;
  }
  __syncthreads();
  int h = 1;
  while (h < lanes) h <<= 1;
  for (h >>= 1; h > 0; h >>= 1) {
    if (lane < h && lane + h < lanes)
      part[threadIdx.x] = add4(part[threadIdx.x], part[threadIdx.x + h * tq]);
    __syncthreads();
  }
}

// Loads of the tree kernel: a quad of the input's row, or of a chunk's
// partial sums (other blocks wrote them: read past this SM's L1).
template <bool kDecode, bool kVec>
struct InputQuad {
  Stripe<kDecode> s;
  int ch;
  __device__ __forceinline__ float4 operator()(int r) const {
    return s.template quad<kVec>(r, ch);
  }
};

template <bool kVec>
struct PartialQuad {
  const float* row;  // the output row's first chunk, at channel ch
  int c, ch;
  __device__ __forceinline__ float4 operator()(int j) const {
    const float* p = row + (int64_t)j * c;
    if (ch >= c) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kVec) return __ldcg(reinterpret_cast<const float4*>(p));
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ch + i < c) v[i] = __ldcg(p + i);
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <bool kDecode, bool kEncode>
__global__ void __launch_bounds__(kPoolThreads, kPoolTreeBlocks)
pool_tree_kernel(Stripe<kDecode> in, float* __restrict__ y,
                 int8_t* __restrict__ man, int8_t* __restrict__ exp,
                 float* __restrict__ partial, unsigned* __restrict__ count,
                 int64_t k, PoolLayout L, bool vec) {
  __shared__ float4 part[kPoolThreads];
  __shared__ bool last;
  const int c = (int)in.c;
  const int64_t o = blockIdx.x / L.chunks, j = blockIdx.x - o * L.chunks;
  const int t = blockIdx.y;
  const int u = threadIdx.x % L.tq, ch = (t * L.tq + u) * 4;
  const int64_t r0 = j * L.chunk;
  const int64_t n = k - r0 < L.chunk ? k - r0 : L.chunk;
  const Stripe<kDecode> s = in.from_row(o * k + r0);
  if (vec)
    pool_block_sum(InputQuad<kDecode, true>{s, ch}, n, L.tq, L.lanes, part);
  else
    pool_block_sum(InputQuad<kDecode, false>{s, ch}, n, L.tq, L.lanes, part);
  const bool c4 = (c & 3) == 0;  // the scratch and y are 16-byte aligned
  if (L.chunks > 1) {
    float* row = partial + o * L.chunks * c;
    if (threadIdx.x < L.tq) {
      store_quad(row + j * c + ch, part[threadIdx.x], ch, c, c4);
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(count + o * L.tiles + t, 1u) ==
             (unsigned)(L.chunks - 1);
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) count[o * L.tiles + t] = 0u;  // for the next launch
    if (c4)
      pool_block_sum(PartialQuad<true>{row + ch, c, ch}, L.chunks, L.tq,
                     L.lanes, part);
    else
      pool_block_sum(PartialQuad<false>{row + ch, c, ch}, L.chunks, L.tq,
                     L.lanes, part);
  }
  const float kf = static_cast<float>(k);
  float* yrow = y + o * c;
  if constexpr (!kEncode) {
    if (threadIdx.x < L.tq)
      store_quad(yrow + ch, div4(part[threadIdx.x], kf), ch, c, c4);
  } else {
    // the tile's quads of the payload row, its padding quads included:
    // at most 64, in whole warps
    const int nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
    const int enc = L.tiles == 1 ? nb * 8 : min(L.tq, nb * 8 - t * L.tq);
    if (threadIdx.x >= (enc + 31) / 32 * 32) return;
    const int q = t * L.tq + threadIdx.x, qc = q * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (threadIdx.x < L.tq && qc < c) a = div4(part[threadIdx.x], kf);
    float v[4] = {a.x, a.y, a.z, a.w};
    int8_t qm[4];
    const int e = smof::bfp8_encode_group<kActLanes, 4>(v, qm);
    if ((int)threadIdx.x >= enc) return;
    store_quad(yrow + qc, a, qc, c, c4);
    *reinterpret_cast<char4*>(man + o * nb * smof::kBfp8Block + qc) =
        make_char4(qm[0], qm[1], qm[2], qm[3]);
    if (q % 8 == 0) exp[o * nb + q / 8] = static_cast<int8_t>(e);
  }
}

// Every pool variant: in (m_out * k, c) -> y (m_out, c), with kEncode the
// payload man (m_out, nb * 32), exp (m_out, nb).  For k > kPoolSerialMaxK
// with more than one chunk an output row: scratch, the partials (m_out,
// chunks, c) f32 (kernels/streaming_conv.py, pool_scratch_size, sizes it),
// and count, m_out * tiles counters, zero at the launch and left zero.
template <bool kDecode, bool kEncode>
int run_pool(Stripe<kDecode> in, float* y, int8_t* man, int8_t* exp,
             float* scratch, unsigned* count, int64_t m_out, int64_t k,
             int64_t bm, cudaStream_t st) {
  const int64_t c = in.c;
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  if (m_out * c <= 0) return (int)cudaGetLastError();
  const bool vec = c % 4 == 0 && (kDecode ? aligned(in.man, 4)
                                          : aligned(in.x, 16));
  if (k <= kPoolSerialMaxK) {
    // 32-bit offsets inside a row block of the input
    const RowTiles t = row_tiles(m_out, bm, INT32_MAX / (k * nb * 32));
    const int ki = (int)k;
    if constexpr (kEncode) {
      const dim3 grid(grid_for(t.rb * nb * kActLanes, kPoolThreads), t.n);
      if (k == 2)
        pool_rows_encode_kernel<kDecode, 2><<<grid, kPoolThreads, 0, st>>>(
            in, y, man, exp, m_out, ki, t.rb, vec);
      else
        pool_rows_encode_kernel<kDecode, 0><<<grid, kPoolThreads, 0, st>>>(
            in, y, man, exp, m_out, ki, t.rb, vec);
    } else {
      const dim3 grid(grid_for(t.rb * ((c + 3) / 4),
                               kPoolThreads * kPoolUnroll), t.n);
      if (k == 2)
        pool_rows_kernel<kDecode, 2><<<grid, kPoolThreads, 0, st>>>(
            in, y, m_out, ki, t.rb, vec);
      else
        pool_rows_kernel<kDecode, 0><<<grid, kPoolThreads, 0, st>>>(
            in, y, m_out, ki, t.rb, vec);
    }
    return (int)cudaGetLastError();
  }
  const PoolLayout L = pool_layout(k, c);
  pool_tree_kernel<kDecode, kEncode>
      <<<dim3((unsigned)(m_out * L.chunks), (unsigned)L.tiles), kPoolThreads,
          0, st>>>(in, y, man, exp, scratch, count, k, L, vec);
  return (int)cudaGetLastError();
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

// x: (m_out * k, c); y: (m_out, c); scratch and count as run_pool says.
extern "C" int smof_pool(const void* x, void* y, void* scratch, void* count,
                         int64_t m_out, int64_t k, int64_t c, int64_t bm,
                         void* stream) {
  return run_pool<false, false>(smof::f32_stripe(x, c), (float*)y, nullptr,
                                nullptr, (float*)scratch, (unsigned*)count,
                                m_out, k, bm, (cudaStream_t)stream);
}

// ... and man: (m_out, nb * 32); exp: (m_out, nb).
extern "C" int smof_pool_encode(const void* x, void* y, void* man, void* exp,
                                void* scratch, void* count, int64_t m_out,
                                int64_t k, int64_t c, int64_t bm,
                                void* stream) {
  return run_pool<false, true>(smof::f32_stripe(x, c), (float*)y,
                               (int8_t*)man, (int8_t*)exp, (float*)scratch,
                               (unsigned*)count, m_out, k, bm,
                               (cudaStream_t)stream);
}

// xman: (m_out * k, nb * 32); xexp: (m_out * k, nb); y: (m_out, c).
extern "C" int smof_pool_decode(const void* xman, const void* xexp, void* y,
                                void* scratch, void* count, int64_t m_out,
                                int64_t k, int64_t c, int64_t bm,
                                void* stream) {
  return run_pool<true, false>(smof::payload_stripe(xman, xexp, c), (float*)y,
                               nullptr, nullptr, (float*)scratch,
                               (unsigned*)count, m_out, k, bm,
                               (cudaStream_t)stream);
}

extern "C" int smof_pool_decode_encode(const void* xman, const void* xexp,
                                       void* y, void* man, void* exp,
                                       void* scratch, void* count,
                                       int64_t m_out, int64_t k, int64_t c,
                                       int64_t bm, void* stream) {
  return run_pool<true, true>(smof::payload_stripe(xman, xexp, c), (float*)y,
                              (int8_t*)man, (int8_t*)exp, (float*)scratch,
                              (unsigned*)count, m_out, k, bm,
                              (cudaStream_t)stream);
}
