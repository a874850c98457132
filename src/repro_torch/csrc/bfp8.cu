// bfp8_quant and bfp8_dequant: the standalone BFP8 stripe codec, an f32
// (R, c) stripe <-> its spill payload, int8 mantissas (R, W) and int8 shared
// exponents (R, W/32), W = nb * 32 >= c.  Channels at or past c are the
// payload's padding: they quantise as zeros and never reach the stripe.
//
// bfp8_quant replaces the TPU kernel _quant_kernel (src/repro/kernels/
// bfp8.py, bfp8_quant): the encode of an evicted stream whose producer
// cannot emit its payload itself (a multi-input add, a fragmented conv).
// Bound on the H100 by bytes: it reads 4 bytes and writes 1 + 1/32 bytes
// per value, with a 4-lane max and one multiply per value.  Design: the
// group encode of act_relu's (streaming_conv.cu) without the relu, with
// twice its bytes in flight a lane: kQuantLanes = 4 lanes per (row,
// 32-channel block), 8 channels a lane read as two 16-byte loads where
// c % 4 == 0 and x is aligned for them (else the channels below c one by
// one), the block's amax from the lane's own 8 values and two
// __shfl_xor_sync steps (smof::bfp8_encode_group), one 8-byte store of
// mantissas a lane and the exponent from the group's first lane.  This
// replaces one warp per block, one value, a 5-step butterfly and a byte
// store a lane.  In a design run on the H100 (8 lanes x 4 values, 4 x 8,
// and 1, 2 or 4 blocks a thread) 4 x 8 with one block a thread was the
// fastest wherever the launch moves tens of MB, and level with 8 x 4 on
// the small launches.
//
// bfp8_dequant replaces _dequant_kernel (same file, bfp8_dequant), y = man *
// 2^(exp-6).  Bound by bytes: it reads 1 + 1/32 bytes and writes 4 bytes per
// value and does one multiply, so it can only run at the memory rate, and
// its writes are four fifths of its bytes.  Design: a thread owns a quad
// (4 channels) of a row, so a warp's 16-byte stores of y are contiguous:
// one 4-byte load of mantissas (byte loads where the payload is not
// aligned for it), the block's exponent byte, one scale, one float4 store
// where c % 4 == 0 (else the quad's channels below c one by one).  Quads
// at or past c have no thread, so the padding channels are never decoded.
// A design run on the H100 (16 or 8 mantissas a thread, 1 or 2 chunks, 4
// quads a thread 32 lanes apart) found every wider layout slower: with 16
// mantissas a thread each float4 store of a warp writes every fourth 16
// bytes of 2 KB, and the writes are what bound it.  What this replaces
// was the same quad layout over the padded (R, W) stripe, with a 64-bit
// division a thread, and a cut copy of the stripe after it.
//
// Both kernels cut the rows into row blocks (grid.y) small enough that a
// thread's index inside its block, and its row from it, are 32-bit.  The
// stripe never passes through a padded copy: the quant reads the (R, c)
// stripe and the dequant writes the (R, c) stripe, row stride c.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuantLanes = 4;  // lanes of one (row, block)
constexpr int kQuantVals = smof::kBfp8Block / kQuantLanes;
constexpr int64_t kMaxLocal = int64_t{1} << 30;  // work items a row block

// Row block blockIdx.y of rb rows: its first row in *r0, its rows returned.
__device__ __forceinline__ int block_rows(int64_t rows, int64_t rb,
                                          int64_t* r0) {
  *r0 = (int64_t)blockIdx.y * rb;
  return (int)(rows - *r0 < rb ? rows - *r0 : rb);
}

// Block (row, b) of the row block's nb blocks a row: kQuantLanes lanes,
// lane `sub` holding channels 32 b + kQuantVals sub ..  vec: c % 4 == 0
// and x is 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
bfp8_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ man,
                  int8_t* __restrict__ exp, int64_t rows, int c, int nb,
                  int64_t rb, bool vec) {
  constexpr int kGroups = kThreads / kQuantLanes;
  int64_t r0;
  const int n = block_rows(rows, rb, &r0) * nb;  // blocks here
  const int warp0 = blockIdx.x * kGroups +
                    (int)(threadIdx.x / 32) * (32 / kQuantLanes);
  if (warp0 >= n) return;  // whole warps leave together: groups shuffle
  const int p = blockIdx.x * kGroups + (int)(threadIdx.x / kQuantLanes);
  const int sub = threadIdx.x % kQuantLanes;
  const int row = p / nb;
  const int ch = (p - row * nb) * smof::kBfp8Block + sub * kQuantVals;
  const bool live = p < n;
  const float* xp = x + (r0 + row) * c + ch;
  float v[kQuantVals];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kQuantVals; j += 4) {
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live && ch + j < c) q = *reinterpret_cast<const float4*>(xp + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kQuantVals; ++j)
      v[j] = live && ch + j < c ? xp[j] : 0.0f;
  }
  int8_t q[kQuantVals];
  const int e = smof::bfp8_encode_group<kQuantLanes, kQuantVals>(v, q);
  if (!live) return;
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kQuantVals; ++j)
    w[j / 4] |= (uint32_t)(uint8_t)q[j] << (8 * (j % 4));
  *reinterpret_cast<uint2*>(man + (r0 + row) * nb * smof::kBfp8Block + ch) =
      make_uint2(w[0], w[1]);
  if (sub == 0) exp[r0 * nb + p] = static_cast<int8_t>(e);
}

// Channels 4 q .. 4 q + 3 of a row, q < q4 = ceil(c / 4).  in_vec: the
// payload is 4-byte aligned (its rows are 32 nb bytes); c4: c % 4 == 0 and
// y is 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
bfp8_dequant_kernel(const int8_t* __restrict__ man,
                    const int8_t* __restrict__ exp, float* __restrict__ y,
                    int64_t rows, int c, int nb, int q4, int64_t rb,
                    bool in_vec, bool c4) {
  int64_t r0;
  const int n = block_rows(rows, rb, &r0) * q4;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int row = i / q4, ch = (i - row * q4) * 4;
  const int64_t r = r0 + row;
  const int8_t* mp = man + r * nb * smof::kBfp8Block + ch;
  const float scale = smof::bfp8_scale(exp[r * nb + ch / smof::kBfp8Block]);
  int8_t m[4] = {0, 0, 0, 0};
  if (in_vec) {
    const char4 mv = *reinterpret_cast<const char4*>(mp);
    m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ch + j < c) m[j] = mp[j];
  }
  const float v[4] = {smof::bfp8_decode_scaled(m[0], scale),
                      smof::bfp8_decode_scaled(m[1], scale),
                      smof::bfp8_decode_scaled(m[2], scale),
                      smof::bfp8_decode_scaled(m[3], scale)};
  float* out = y + r * c + ch;
  if (c4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ch + j < c) out[j] = v[j];
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Rows a row block (grid.y) so that a block's work items number at most
// kMaxLocal; 0 where the grid cannot hold the rows.
int64_t row_block(int64_t rows, int64_t per_row, unsigned* blocks_y) {
  int64_t rb = kMaxLocal / per_row;
  if (rb > rows) rb = rows;
  const int64_t by = (rows + rb - 1) / rb;
  if (rb < 1 || by > 65535) return 0;
  *blocks_y = (unsigned)by;
  return rb;
}

}  // namespace

// x: (rows, c) f32, row stride c; man: (rows, width), exp: (rows, width /
// 32), width a multiple of 32 and >= c.
extern "C" int smof_bfp8_quant(const void* x, void* man, void* exp,
                               int64_t rows, int64_t c, int64_t width,
                               void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaGetLastError();
  if (width % smof::kBfp8Block || c > width || c < 0 || width > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const int nb = (int)(width / smof::kBfp8Block);
  unsigned by;
  const int64_t rb = row_block(rows, nb, &by);
  if (rb == 0) return (int)cudaErrorInvalidValue;
  const int64_t per = kThreads / kQuantLanes;  // blocks a thread block
  const dim3 grid((unsigned)((rb * nb + per - 1) / per), by);
  bfp8_quant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)man, (int8_t*)exp, rows, (int)c, nb, rb,
      c % 4 == 0 && aligned(x, 16));
  return (int)cudaGetLastError();
}

// man: (rows, width), exp: (rows, width / 32); y: (rows, c), row stride c,
// c <= width.
extern "C" int smof_bfp8_dequant(const void* man, const void* exp, void* y,
                                 int64_t rows, int64_t c, int64_t width,
                                 void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaGetLastError();
  if (width % smof::kBfp8Block || c > width || width > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const int q4 = (int)((c + 3) / 4);
  unsigned by;
  const int64_t rb = row_block(rows, q4, &by);
  if (rb == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rb * q4 + kThreads - 1) / kThreads), by);
  bfp8_dequant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)man, (const int8_t*)exp, (float*)y, rows, (int)c,
      (int)(width / smof::kBfp8Block), q4, rb, aligned(man, 4),
      c % 4 == 0 && aligned(y, 16));
  return (int)cudaGetLastError();
}
