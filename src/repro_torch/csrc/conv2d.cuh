// conv2d: the 1x1 channel mix y = x @ w in f32 for conv, matmul and deconv
// vertices whose weight the plan pins whole; x (m, k), w (k, n), y (m, n),
// all three ragged.
//
// Replaces the TPU kernel _conv_kernel (src/repro/kernels/streaming_conv.py,
// conv2d), one full-K jnp.dot per (row block, column block) tile.  Shapes
// on the main paths: m from 1 (the squeeze-excitation convs) to 262144, k
// from 3 (X3D-M's stem) to 384, n from 16 to 384.  At m >= 6400 and k >= 64
// it does 2 m k n flops on (m k + k n + m n) * 4 bytes, 10-60 flops a byte:
// bound by operations at f32's 67 TFLOP/s, by bytes near the 3xTF32
// split's 165.  Design: the tensor cores through the split of tf32x3.cuh
// (three mma.sync.m16n8k8 TF32 products of hi/lo operands, small terms
// first, within 2e-4 of the f32 product where one TF32 product is not).
//
// * Staging.  x (or the decode variants' int8 mantissas) and w come through
//   a 3-stage cp.async ring in dynamic shared memory, BK columns of x and
//   BK rows of w a stage, zero-filled past m, k and n.  An x whose rows do
//   not all start 16-byte aligned (a base off 16 bytes, or k % 4 != 0: the
//   stem's K = 3) takes 4-byte copies, and so does such a w (n % 4 != 0);
//   a mantissa base that is not 16-byte aligned takes byte loads.  The
//   exponents of a block's rows (one a row and 32 columns) are loaded
//   once, before the first K step.
// * Split once per staged value.  Once a stage lands, the block splits its
//   x tile and its w tile into hi and lo planes of shared memory in one
//   pass (decoding the mantissas first in the decode variants, with
//   bfp8.cuh's decode, the standalone dequant's arithmetic), w transposed
//   to (n, k) so that both operands' fragments are ldmatrix loads.  The
//   split's instructions, not the products, set the pace of a kernel that
//   splits per warp (tf32x3.cuh); here each value is split once per block,
//   not once per warp that loads it.  Plane rows are padded to BK + 4
//   words, so the split's stores and ldmatrix's rows hit distinct banks.
// * Tile.  A block covers BM rows and bn <= 128 columns (bc, or n cut
//   evenly), so x is read from device memory once per row block wherever
//   n <= 128.  A warp owns 32 rows and 32 columns (one codec block): two
//   m16 by four n8 fragments of f32 accumulators.  BM = 128 and 64 step K
//   by 16 (a block's ring and planes fit two or three blocks an SM), BM =
//   32, the instance of small m, by 32 (half the K steps for the m = 1
//   convs, whose time is the K loop's latency).  Fragments wholly past m
//   and warps wholly past n are not multiplied, rows past m not split.
// * Pipeline.  Two buffers of planes: step kt splits stage kt + 1 into one
//   while it multiplies stage kt from the other, one barrier a step.  A
//   tile of more than 4 warps copies and splits with all of them; a tile
//   of at most 4 (small m or n, where the block count and not the card's
//   throughput sets the time) gets 4 producer warps more, which alone copy
//   and split, so that its K loop runs at the products' pace.
// * Issue order.  Each accumulator takes mma_tf32x3's three products in
//   its order, but each product is issued for all eight accumulators of a
//   warp before the next, so that in-order issue does not stall on the
//   result of the one before.
// * Sum order: a function of K alone.  Every output element is summed over
//   the k8 slices in order, each as mma_tf32x3's three products, from a
//   zero accumulator; slices wholly past k are skipped.  No split-K, no
//   atomics: no tile, m, grid or instance changes a bit of y, so the
//   staged, pipelined and served paths stay bit for bit each other.
//
// conv2d_encode replaces _conv_enc_kernel (same file): the same product and,
// from the same launch, the BFP8 spill payload of y zero-padded to the
// 32-channel block (int8 mantissas (m, n32), one int8 exponent per row and
// block (m, n32 / 32)).  A warp's 32 columns are one codec block, and the
// block's values of a row lie in one quad (lanes 4g..4g+3, 8 values each
// over the four n8 fragments): the amax over a lane's values, then over
// the quad in 2 steps of __shfl_xor_sync, and each lane writes its f32
// values, its mantissas two at a time and, for the first of the quad, the
// exponent, with the codec of bfp8.cuh.  Columns n..n32 encode zeros, as
// the plain version pads y; rows past m write nothing.
//
// conv2d_decode and conv2d_decode_encode replace _conv_dec_kernel and
// _conv_dec_enc_kernel (same file): the input edge arrives as its BFP8
// spill payload (row stride ceil(k / 32) * 32 bytes, one exponent per 32
// columns), staged as int8 (a quarter of x's bytes) and decoded in the
// split pass; only the first k columns enter the product.  kDecode and
// kEncode are template parameters over one product loop, so y is bit for
// bit the plain kernel's y (on the bfp8_dequant kernel's output for the
// decode variants).
//
// Tiles (the plan's tile_bm / tile_bc, the reference's bm / bc): bm picks
// the instance by its row tile, BM = 32, 64 or 128 (bm 0: the largest whose
// blocks number at least the card's SMs, else 32; a bm below 32 rounds up
// to 32, one between two instances up to the larger, one above 128 down to
// 128); bc, a multiple of 32, sets the columns a block covers, at most 128
// (bc 0: round_up(n, 32) cut into the fewest blocks of at most 128, as
// evenly as 32-column steps allow).
//
// This header holds the kernel and its launch; conv2d.cu instantiates the
// plain and encode variants, conv2d_decode.cu the two decode variants, so
// that nvcc builds the two halves in parallel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int STAGES = 3;
constexpr int BN_MAX = 128;       // columns a block covers at most
constexpr int WN = 32;            // a warp's columns: one codec block
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory

static_assert(WN == smof::kBfp8Block, "a warp's columns = one codec block");

constexpr int WM = 32;            // a warp's rows: two m16 fragments
constexpr int MFRAGS = WM / 16;
// A block whose tile has at most PRODUCERS warps gets PRODUCERS more, which
// alone copy and split while the tile's warps multiply
constexpr int PRODUCERS = 4;

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int BK = BM == 32 ? 32 : 16;  // K step
  static constexpr int LD = BK + 4;  // words a row: x ring, both planes
  // the most threads a block has: its widest tile's warps, or a tile of at
  // most PRODUCERS warps and its producers
  static constexpr int MAX_THREADS =
      32 * (WARPS_M * (BN_MAX / WN) > 2 * PRODUCERS ? WARPS_M * (BN_MAX / WN)
                                                    : 2 * PRODUCERS);
  // at most 128 registers a thread
  static constexpr int MIN_BLOCKS =
      65536 / (MAX_THREADS * 128) > 0 ? 65536 / (MAX_THREADS * 128) : 1;
};

// Byte offsets of the dynamic shared memory of a block covering bn
// columns: the ring's x and w stages, two buffers of the hi/lo planes of x
// (BM, LD) and of w transposed (bn, LD), and the decode's exponents
// (BM, nbk).
struct Layout {
  int wring, xplane, wplane, exps, bytes;
};

template <int BM, bool kDecode>
__host__ __device__ inline int x_stage_bytes() {
  return kDecode ? BM * Tile<BM>::BK : BM * Tile<BM>::LD * 4;
}

template <int BM, bool kDecode>
__host__ __device__ inline Layout layout(int bn, int nbk) {
  using T = Tile<BM>;
  Layout L;
  L.wring = STAGES * x_stage_bytes<BM, kDecode>();
  L.xplane = L.wring + STAGES * T::BK * (bn + 4) * 4;
  L.wplane = L.xplane + 4 * BM * T::LD * 4;
  L.exps = L.wplane + 4 * bn * T::LD * 4;
  L.bytes = L.exps + (kDecode ? (BM * nbk + 15) / 16 * 16 : 0);
  return L;
}

// routes: bit 0, x (or the mantissas) by 16-byte copies; bit 1, w by
// 16-byte copies.
constexpr int kX16 = 1, kW16 = 2;

// x: the (m, k) input, or with kDecode its payload xman (m, nbk * 32) and
// xexp (m, nbk).  kEncode: also write the payload man (m, nb * 32) and exp
// (m, nb), nb = ceil(n / 32).  The block covers bn columns.
template <int BM, bool kDecode, bool kEncode>
__global__ void __launch_bounds__(Tile<BM>::MAX_THREADS, Tile<BM>::MIN_BLOCKS)
conv2d_kernel(const float* __restrict__ x, const int8_t* __restrict__ xman,
              const int8_t* __restrict__ xexp, const float* __restrict__ w,
              float* __restrict__ y, int8_t* __restrict__ man,
              int8_t* __restrict__ exp, int64_t m, int k, int n, int bn,
              int routes) {
  using T = Tile<BM>;
  constexpr int BK = T::BK, LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbk = (k + 31) / 32;
  const Layout L = layout<BM, kDecode>(bn, nbk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cwarps = T::WARPS_M * (bn / WN);  // the tile's warps
  // the threads that copy and split: the producer warps past the tile's,
  // or every thread
  const bool ws = cwarps <= PRODUCERS;
  const int tid = (int)threadIdx.x - (ws ? 32 * cwarps : 0);
  const int nthreads = (int)blockDim.x - (ws ? 32 * cwarps : 0);
  const bool producer = !ws || warp >= cwarps;
  const int wm = (warp % T::WARPS_M) * WM;
  const int wn = (warp / T::WARPS_M) * WN;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * bn;
  const int ldb = bn + 4;
  const int ktiles = (k + BK - 1) / BK;
  // plane buffer pb: x hi, x lo (BM, LD), then w hi, w lo (bn, LD)
  uint32_t* const xplanes = reinterpret_cast<uint32_t*>(smem + L.xplane);
  uint32_t* const wplanes = reinterpret_cast<uint32_t*>(smem + L.wplane);
  int8_t* const exps = reinterpret_cast<int8_t*>(smem + L.exps);

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    unsigned char* xs = smem + s * x_stage_bytes<BM, kDecode>();
    if constexpr (kDecode) {
      const int64_t ld = (int64_t)nbk * 32;  // payload row stride, bytes
      if (routes & kX16) {
        for (int i = tid; i < BM * (BK / 16); i += nthreads) {
          const int r = i / (BK / 16), q = i % (BK / 16);
          const bool in = row0 + r < m;
          tf32x3::cp_async16(xs + r * BK + 16 * q,
                             in ? xman + (row0 + r) * ld + k0 + 16 * q : xman,
                             in);
        }
      } else {
        for (int i = tid; i < BM * BK; i += nthreads) {
          const int r = i / BK, c = i % BK;
          xs[r * BK + c] =
              row0 + r < m ? xman[(row0 + r) * ld + k0 + c] : int8_t(0);
        }
      }
    } else {
      float* xf = reinterpret_cast<float*>(xs);
      if (routes & kX16) {
        for (int i = tid; i < BM * (BK / 4); i += nthreads) {
          const int r = i / (BK / 4), q = i % (BK / 4);
          const int gk = k0 + 4 * q;
          const bool in = row0 + r < m && gk < k;
          tf32x3::cp_async16(xf + r * LD + 4 * q,
                             in ? x + (row0 + r) * k + gk : x, in);
        }
      } else {
        for (int i = tid; i < BM * BK; i += nthreads) {
          const int r = i / BK, c = i % BK;
          const int gk = k0 + c;
          const bool in = row0 + r < m && gk < k;
          tf32x3::cp_async4(xf + r * LD + c, in ? x + (row0 + r) * k + gk : x,
                            in);
        }
      }
    }
    float* ws = reinterpret_cast<float*>(smem + L.wring) + s * BK * ldb;
    if (routes & kW16) {
      const int q4 = bn / 4;
      for (int i = tid; i < BK * q4; i += nthreads) {
        const int kk = i / q4, q = i - kk * q4;
        const int gk = k0 + kk, gc = col0 + 4 * q;
        const bool in = gk < k && gc < n;
        tf32x3::cp_async16(ws + kk * ldb + 4 * q,
                           in ? w + (int64_t)gk * n + gc : w, in);
      }
    } else {
      for (int i = tid; i < BK * bn; i += nthreads) {
        const int kk = i / bn, c = i - kk * bn;
        const int gk = k0 + kk, gc = col0 + c;
        const bool in = gk < k && gc < n;
        tf32x3::cp_async4(ws + kk * ldb + c,
                          in ? w + (int64_t)gk * n + gc : w, in);
      }
    }
  };

  // ring slot s (K step kt) -> plane buffer pb: x as (BM, LD), w as (bn, LD)
  auto split_stage = [&](int s, int kt, int pb) {
    const int k0 = kt * BK;
    uint32_t* const xhi = xplanes + pb * 2 * BM * LD;
    uint32_t* const xlo = xhi + BM * LD;
    uint32_t* const whi = wplanes + pb * 2 * bn * LD;
    uint32_t* const wlo = whi + bn * LD;
    const unsigned char* xs = smem + s * x_stage_bytes<BM, kDecode>();
    // rows past m are left as they are: a row of A meets only its own row
    // of the product, which is never written
    const int rows = m - row0 < BM ? (int)(m - row0) : BM;
    for (int i = tid; i < rows * (BK / 4); i += nthreads) {
      const int r = i / (BK / 4), q = i % (BK / 4);
      float v[4];
      if constexpr (kDecode) {
        const char4 c4 = *reinterpret_cast<const char4*>(xs + r * BK + 4 * q);
        const int8_t mv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float scale =
            smof::bfp8_scale(exps[r * nbk + (k0 + 4 * q) / 32]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = k0 + 4 * q + j < k ? smof::bfp8_decode_scaled(mv[j], scale)
                                    : 0.0f;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(xs) + r * LD + 4 * q);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      }
      uint4 hi, lo;
      tf32x3::split(v[0], hi.x, lo.x);
      tf32x3::split(v[1], hi.y, lo.y);
      tf32x3::split(v[2], hi.z, lo.z);
      tf32x3::split(v[3], hi.w, lo.w);
      *reinterpret_cast<uint4*>(xhi + r * LD + 4 * q) = hi;
      *reinterpret_cast<uint4*>(xlo + r * LD + 4 * q) = lo;
    }
    const float* ws = reinterpret_cast<const float*>(smem + L.wring) +
                      s * BK * ldb;
    // lanes along k: the ring's reads (row stride = 4 mod 32 words) and
    // the transposed plane's writes hit distinct banks
    for (int i = tid; i < BK * (bn / 4); i += nthreads) {
      const int kk = i % BK, q = i / BK;
      const float4 f = *reinterpret_cast<const float4*>(ws + kk * ldb + 4 * q);
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32x3::split(v[j], whi[(4 * q + j) * LD + kk],
                      wlo[(4 * q + j) * LD + kk]);
    }
  };

  float acc[MFRAGS][4][4];
#pragma unroll
  for (int i = 0; i < MFRAGS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (producer) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < ktiles) load_stage(s, s);
      tf32x3::cp_async_commit();
    }
    if constexpr (kDecode) {
      // the rows' exponents, while the first stages are in flight
      for (int i = tid; i < BM * nbk; i += nthreads) {
        const int r = i / nbk;
        exps[i] = row0 + r < m ? xexp[row0 * nbk + i] : int8_t(0);
      }
    }
  }

  // ldmatrix rows: lane l reads row l % 8 of tile l / 8
  const int lq = lane >> 3, lr = lane & 7;
  // m16 fragments with a row below m (warp-uniform); the rest are skipped
  const int live = warp >= cwarps || row0 + wm >= m || col0 + wn >= n ? 0
                   : row0 + wm + 16 < m ? 2 : 1;
  // the producers' barrier: every copy of a stage has landed
  auto producers_sync = [&] {
    if (ws)
      asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
    else
      __syncthreads();
  };
  if (producer) {
    tf32x3::cp_async_wait<STAGES - 1>();
    producers_sync();
    split_stage(0, 0, 0);
  }
  // Step kt splits stage kt + 1 into one plane buffer while it multiplies
  // stage kt from the other: one barrier a step
  for (int kt = 0; kt < ktiles; ++kt) {
    // at the barrier: stage kt is split into buffer kt & 1, every warp is
    // done multiplying buffer (kt + 1) & 1 and reading ring slot
    // kt % STAGES, and stage kt + 1 has landed (the producer warps wait for
    // it among themselves)
    if (!ws) tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (producer && kt + 1 < ktiles) {
      if (ws) {
        tf32x3::cp_async_wait<STAGES - 2>();
        producers_sync();
      }
      if (kt + STAGES < ktiles) load_stage(kt % STAGES, kt + STAGES);
      tf32x3::cp_async_commit();
      split_stage((kt + 1) % STAGES, kt + 1, (kt + 1) & 1);
    }

    const int k0 = kt * BK;
    const uint32_t* const xhi = xplanes + (kt & 1) * 2 * BM * LD;
    const uint32_t* const xlo = xhi + BM * LD;
    const uint32_t* const whi = wplanes + (kt & 1) * 2 * bn * LD;
    const uint32_t* const wlo = whi + bn * LD;
    // the products of one k8 slice; both: both m16 fragments are live
    auto slice = [&](int kk, bool both) {
      // B: tiles (n8 fragment j, k 0-3), (j, k 4-7), (j + 1, k 0-3), ...
      tf32x3::FragB b[4];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int off =
            (wn + 8 * (j + (lq >> 1)) + lr) * LD + kk + 4 * (lq & 1);
        tf32x3::ldmatrix_x4(b[j].hi[0], b[j].hi[1], b[j + 1].hi[0],
                            b[j + 1].hi[1], whi + off);
        tf32x3::ldmatrix_x4(b[j].lo[0], b[j].lo[1], b[j + 1].lo[0],
                            b[j + 1].lo[1], wlo + off);
      }
      // A: tiles (rows 0-7, k 0-3), (rows 8-15, k 0-3), (0-7, 4-7), ...
      tf32x3::FragA a[MFRAGS];
#pragma unroll
      for (int i = 0; i < MFRAGS; ++i) {
        const int off =
            (wm + 16 * i + 8 * (lq & 1) + lr) * LD + kk + 4 * (lq >> 1);
        tf32x3::ldmatrix_x4(a[i].hi[0], a[i].hi[1], a[i].hi[2], a[i].hi[3],
                            xhi + off);
        tf32x3::ldmatrix_x4(a[i].lo[0], a[i].lo[1], a[i].lo[2], a[i].lo[3],
                            xlo + off);
      }
      // mma_tf32x3's three products, a_lo b_hi, a_hi b_lo, a_hi b_hi, in
      // that order on every accumulator, but each issued for all of them
      // before the next: 8 independent products stand between two that
      // depend on each other, where in-order issue would stall on each
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < MFRAGS; ++i) {
          if (i > 0 && !both) break;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tf32x3::mma_tf32(acc[i][j], p == 0 ? a[i].lo : a[i].hi,
                             p == 1 ? b[j].lo : b[j].hi);
        }
    };
    if (live == 2 && k0 + BK <= k) {
      // the common step, without a branch between its slices' loads and
      // products
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) slice(kk, true);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        if (k0 + kk >= k || live == 0) break;  // block- or warp-uniform
        slice(kk, live == 2);
      }
    }
  }

  // epilogue: c[2h], c[2h + 1] of fragment (i, j) are row wm + 16 i + g +
  // 8 h, columns wn + 8 j + 2 t and + 1 of the block
  if (warp >= cwarps) return;
  const int nb = (n + WN - 1) / WN;
  const int cb = (col0 + wn) / WN;  // this warp's codec block
  // every row's values (columns past n zero) and block exponent before
  // any store, so that the rows' shuffles overlap
  float v[MFRAGS][2][8];
  int e[MFRAGS][2] = {};
#pragma unroll
  for (int i = 0; i < MFRAGS; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        v[i][h][2 * j] = c < n ? acc[i][j][2 * h] : 0.0f;
        v[i][h][2 * j + 1] = c + 1 < n ? acc[i][j][2 * h + 1] : 0.0f;
      }
  if constexpr (kEncode) {
    float amax[MFRAGS][2];
#pragma unroll
    for (int i = 0; i < MFRAGS; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        amax[i][h] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          amax[i][h] = smof::bfp8_amax_step(amax[i][h], fabsf(v[i][h][j]));
      }
    // the quad holds a row's block; every lane takes part, rows past m
    // included
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int i = 0; i < MFRAGS; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          amax[i][h] = smof::bfp8_amax_step(
              amax[i][h], __shfl_xor_sync(0xffffffffu, amax[i][h], off));
#pragma unroll
    for (int i = 0; i < MFRAGS; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) e[i][h] = smof::bfp8_exponent(amax[i][h]);
  }
#pragma unroll
  for (int i = 0; i < MFRAGS; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        float* out = y + r * n + c;
        if ((n & 1) == 0) {
          if (c < n) *reinterpret_cast<float2*>(out) =
              make_float2(v[i][h][2 * j], v[i][h][2 * j + 1]);
        } else {
          if (c < n) out[0] = v[i][h][2 * j];
          if (c + 1 < n) out[1] = v[i][h][2 * j + 1];
        }
      }
      if constexpr (kEncode) {
        if (cb >= nb) continue;  // a warp wholly past the payload
        const float scale = smof::bfp8_scale(e[i][h]);
        int8_t* row = man + r * nb * WN + cb * WN;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<char2*>(row + 8 * j + 2 * t) =
              make_char2(smof::bfp8_mantissa(v[i][h][2 * j], scale),
                         smof::bfp8_mantissa(v[i][h][2 * j + 1], scale));
        if (t == 0) exp[r * nb + cb] = static_cast<int8_t>(e[i][h]);
      }
    }
  }
}

template <int BM, bool kDecode, bool kEncode>
int launch_conv2d(const float* x, const int8_t* xman, const int8_t* xexp,
                  const float* w, float* y, int8_t* man, int8_t* exp,
                  int64_t m, int64_t k, int64_t n, int bn, cudaStream_t st) {
  constexpr auto kernel = conv2d_kernel<BM, kDecode, kEncode>;
  const Layout L = layout<BM, kDecode>(bn, (int)((k + 31) / 32));
  const int64_t grid_y = (n + bn - 1) / bn;
  if (L.bytes > MAX_SMEM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = tf32x3::set_shared_memory<kernel>(MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const void* xsrc = kDecode ? (const void*)xman : (const void*)x;
  const int routes =
      ((uintptr_t)xsrc % 16 == 0 && (kDecode || k % 4 == 0) ? kX16 : 0) |
      ((uintptr_t)w % 16 == 0 && n % 4 == 0 ? kW16 : 0);
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)grid_y);
  const int cwarps = Tile<BM>::WARPS_M * (bn / WN);
  const int threads = 32 * (cwarps <= PRODUCERS ? cwarps + PRODUCERS : cwarps);
  kernel<<<grid, threads, L.bytes, st>>>(x, xman, xexp, w, y, man, exp, m,
                                         (int)k, (int)n, bn, routes);
  return (int)cudaGetLastError();
}

// The current device's SMs, read once per device.
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  return count[dev];
}

// bm, bc as the note at the top says.
template <bool kDecode, bool kEncode>
int run_conv2d(const void* x, const void* xman, const void* xexp,
               const void* w, void* y, void* man, void* exp, int64_t m,
               int64_t k, int64_t n, int64_t bm, int64_t bc, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k <= 0 || k > INT32_MAX / 2 || n > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  // bc 0: the fewest column blocks of at most BN_MAX, as even as the
  // codec block allows (n = 192: two of 96, not 128 and 64)
  const int64_t n32 = (n + WN - 1) / WN * WN;
  const int64_t nblk = (n32 + BN_MAX - 1) / BN_MAX;
  int64_t bn = bc > 0 ? bc : ((n32 + nblk - 1) / nblk + WN - 1) / WN * WN;
  bn = bn < n32 ? bn : n32;
  bn = bn < BN_MAX ? bn : BN_MAX;
  if (bm == 0) {
    // the largest row tile whose blocks still fill the card once
    const int64_t gy = (n + bn - 1) / bn, sms = sm_count();
    bm = (m + 127) / 128 * gy >= sms ? 128 : (m + 63) / 64 * gy >= sms ? 64
                                                                      : 32;
  }
  const float* xf = static_cast<const float*>(x);
  const int8_t* xm = static_cast<const int8_t*>(xman);
  const int8_t* xe = static_cast<const int8_t*>(xexp);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  int8_t* pm = static_cast<int8_t*>(man);
  int8_t* pe = static_cast<int8_t*>(exp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm <= 32)
    return launch_conv2d<32, kDecode, kEncode>(xf, xm, xe, wf, yf, pm, pe, m,
                                               k, n, (int)bn, st);
  if (bm <= 64)
    return launch_conv2d<64, kDecode, kEncode>(xf, xm, xe, wf, yf, pm, pe, m,
                                               k, n, (int)bn, st);
  return launch_conv2d<128, kDecode, kEncode>(xf, xm, xe, wf, yf, pm, pe, m,
                                              k, n, (int)bn, st);
}

}  // namespace
