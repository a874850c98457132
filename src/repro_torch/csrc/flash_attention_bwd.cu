// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// from the forward's output o and its per-row log-sum-exp lse, as two
// kernels on q, o, dO of shape (B, S, H, D), k, v of shape (B, Sk, H, D)
// and lse, delta of shape (B, H, S), all f32, the KV heads already repeated
// to H.  A causal call has Sk == S; a non-causal one may have keys of their
// own length (the encoder-decoder's cross attention: S decoder rows against
// Sk = 1500 encoder frames).  With the scaled scores s = q^ k^T [causal
// mask -2^30], q^ = q D^-1/2 rounded once:
//   P = exp(s - lse), dV = P^T dO, dP = dO V^T, D_i = rowsum(dO o O),
//   dS = P o (dP - D), dQ = dS K D^-1/2, dK = dS^T q^.
//
// The TPU package has no backward kernel: XLA differentiates its plain
// chunked_attention (src/repro/models/attention.py), the Pallas kernel's own
// oracle.  These are the gradient of that function on the card, so that the
// training route runs no plain version.
//
// Bound on the H100: at yi-6b's train shape (S = 1024, D = 128, causal) the
// two kernels do 7 products of about S^2 D operations a (b, h) (3 in dq: s,
// dP and dQ; 4 in dkdv: s, dP, dV and dK; dq recomputes s and dP so that no
// sum needs atomics) on about 9 S D values of 4 bytes: bound by operations.
// Every product runs on the tensor cores through the 3xTF32 split of
// tf32x3.cuh (mma.sync m16n8k8, f32 accuracy), which bounds the pair at
// 3 x 7 S^2 D / 495 TFLOP/s; no atomics, every sum in a fixed order, so two
// launches are bit for bit.
//
// Both kernels: 8 warps (256 threads) a block, in 4 pairs; a pair owns 16
// rows of the block's stationary operand (64 query rows in dq, 64 keys in
// dkdv) and walks tiles of 32 rows of the moving operand (keys in dq, query
// rows in dkdv) through a double-buffered cp.async ring, the next tile in
// flight while the warps multiply this one.  Per tile, warp m of a pair
// computes the scores and dP of the pair's 16 rows against tile rows
// [16 m, 16 m + 16) over all of D (accumulators of 16 x 16, the even and odd
// k8 steps apart: 8 chains of products in flight), masks them (only a tile
// that reaches past S, past Sk or past a diagonal), and writes dS (and P in
// dkdv) to the pair's slice of shared memory, which takes them from the
// accumulator layout to the A operand's; after a barrier of the pair's 64
// threads, warp m multiplies the whole (16, 32) slice into columns [m D/2,
// (m + 1) D/2) of its accumulators: dQ in dq (16 x D/2: 32 registers at D
// = 128), dK and dV in dkdv (64 registers).  A pair skips a tile wholly
// above its diagonal; the heaviest blocks are issued first.
//
// Operands.  The stationary rows are the A operand of s and dP (q^ and dO in
// dq, k and v in dkdv): they are split once, when the block starts, into hi
// and lo planes of fragments in shared memory (a lane's 4 values of one k8
// step in one 16-byte word, so a fragment is one conflict-free 16-byte load
// a plane and the tile loop splits none of them).  The moving tile is read
// as a B operand in both of mma's patterns and split as it is loaded:
// (row g, column t) for s and dP, two fragments in one ldmatrix; (row t,
// column g) for the second product (dQ's k in dq, dV's dO and dK's q^ in
// dkdv), one 32-bit load a value.  Its rows are D floats (32 at D = 16),
// unpadded, with 16-byte chunks XOR-swizzled by row: column c of row r lies
// at c ^ (8 (r & 3) + (r & 4)), which keeps both patterns, ldmatrix's rows
// and the cp.async chunks free of bank conflicts (no row stride does both
// patterns: (g, t) wants a stride of 4 mod 8 words, (t, g) one of 8 or 24
// mod 32).  The slices are padded to 36 floats a row, so that their
// ldmatrix rows fall in distinct banks.  q^ in dkdv is staged raw and scaled
// as it is read (one f32 product, the reference's q * D^-1/2).
//
// Shared memory at D = 128: the planes 131,072 bytes (4 of 32,768), the ring
// 65,536 (2 stages of two 32-row tiles), dS 9,216 (dq) or P^T and dS^T
// 18,432 (dkdv), lse and D 512: 206,336 bytes (dq), 215,552 (dkdv), so one
// block of 8 warps an SM, as many warps as the forward's two blocks of 4;
// ptxas gives them 188 and 196 registers a thread.  At D = 16 two blocks fit
// an SM, at D = 32 two of dq, at D = 64 one (registers).  16-row moving
// tiles, or 4-warp blocks of 2 pairs, would fit two blocks at D = 128 but
// halve the chains of products in flight or double the planes' share.
// __launch_bounds__(256, 1) leaves ptxas up to 255 registers a thread.
//
// Rows past S (query rows) or Sk (keys) are read as zeros and never
// written; a key past Sk gets a probability of exactly 0 (dq), a query row
// past S a P of 0 (dkdv); the dkdv grid runs ceil(Sk / 64) key blocks over
// all S query rows; the causal mask is -2^30, as the forward's; the
// exponentials are full expf.
// flash_attention_bwd_dq also writes D_i of its rows, which
// flash_attention_bwd_dkdv (launched after it on the same stream) reads.
//
// The bf16 pair (flash_attention_bwd_dq_bf16, _dkdv_bf16) has a body of its
// own on the bf16 tensor cores: flash_attention_bwd_bf16.cu.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 8, PAIRS = WARPS / 2, THREADS = 32 * WARPS;
constexpr int ROWS = 16 * PAIRS;  // query rows of a dq block, keys of dkdv's
constexpr int TILE = 32;          // keys of a dq tile, query rows of dkdv's
constexpr int LDS = TILE + 4;     // row stride of the dS, P^T, dS^T slices
constexpr float kNegInf = -1073741824.0f;  // -2^30, the forward's mask

template <int D>
struct Layout {
  static constexpr int NKS = D / 8;   // k8 steps over D
  static constexpr int NH = D / 16;   // n fragments of a warp's half of D
  static constexpr int LD = D < 32 ? 32 : D;      // staged row stride
  static constexpr int FRAG = PAIRS * NKS * 32;   // 16-byte words a plane
  static constexpr int TILEF = TILE * LD;         // floats a staged tile
  static constexpr int SLICE = 16 * LDS;          // floats a pair's slice
  static constexpr size_t PLANES = 4 * FRAG * sizeof(uint4);
  // planes; ring of 2 x (k, v); dS slices; lse and D of the rows
  static constexpr size_t DQ =
      PLANES + (4 * TILEF + PAIRS * SLICE + 2 * ROWS) * sizeof(float);
  // planes; ring of 2 x (q, dO); P^T, dS^T slices; 2 x (lse, D) of the rows
  static constexpr size_t DKDV =
      PLANES + (4 * TILEF + 2 * PAIRS * SLICE + 4 * TILE) * sizeof(float);
};

// where column c of staged row r lies (see the top of this file)
template <int LD>
__device__ __forceinline__ int at(int r, int c) {
  return r * LD + (c ^ (((r & 3) << 3) | (r & 4)));
}

// Rows r0 .. r0 + 63 of a (S, row)-strided operand, times scale (one f32
// product), split into the hi and lo planes of their A fragments: word (p,
// d, lane) holds rows 16 p + g and 16 p + g + 8, columns 8 d + t and 8 d +
// t + 4 in a's order; rows past S as zeros.
template <int D>
__device__ __forceinline__ void split_rows(uint4* __restrict__ hi,
                                           uint4* __restrict__ lo,
                                           const float* __restrict__ src,
                                           int64_t r0, int64_t S,
                                           int64_t row, float scale) {
  using L = Layout<D>;
  for (int e = threadIdx.x; e < L::FRAG; e += THREADS) {
    const int lane = e & 31, d = (e >> 5) % L::NKS, p = e / (32 * L::NKS);
    const int r = 16 * p + (lane >> 2), c = 8 * d + (lane & 3);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t pos = r0 + r + 8 * (i & 1);
      x[i] = pos < S ? src[pos * row + c + 4 * (i >> 1)] * scale : 0.0f;
    }
    uint4 h, l;
    tf32x3::split(x[0], h.x, l.x);
    tf32x3::split(x[1], h.y, l.y);
    tf32x3::split(x[2], h.z, l.z);
    tf32x3::split(x[3], h.w, l.w);
    hi[e] = h;
    lo[e] = l;
  }
}

__device__ __forceinline__ tf32x3::FragA frag_a(const uint4* hi,
                                                const uint4* lo, int i) {
  const uint4 h = hi[i], l = lo[i];
  tf32x3::FragA a;
  a.hi[0] = h.x, a.hi[1] = h.y, a.hi[2] = h.z, a.hi[3] = h.w;
  a.lo[0] = l.x, a.lo[1] = l.y, a.lo[2] = l.z, a.lo[3] = l.w;
  return a;
}

// cp.async of rows r0 .. r0 + 31 of a (S, row)-strided operand into a
// swizzled [TILE][LD] tile, rows past S zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t r0, int64_t S,
                                          int64_t row) {
  using L = Layout<D>;
  constexpr int C4 = D / 4, N = TILE * C4;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (N % THREADS == 0 || idx < N) {
      const int r = idx / C4, c = idx % C4 * 4;
      // a row past S is zero-filled from a valid address that is not read
      const bool in = r0 + r < S;
      tf32x3::cp_async16(dst + at<L::LD>(r, c),
                         in ? src + (r0 + r) * row + c : src, in);
    }
  }
}

// The (row g, column t) B fragments of two n fragments of a staged tile, at
// rows r0 + [0, 16) and k8 step d, in one ldmatrix: b[j][0] = (r0 + 8 j + g,
// 8 d + t), b[j][1] = (r0 + 8 j + g, 8 d + t + 4), raw f32 bits
template <int LD>
__device__ __forceinline__ void tile_b2(const float* tile, int r0, int d,
                                        int lane, uint32_t (&b)[2][2]) {
  const int m = lane >> 3;  // the 8 x 4 matrix whose row this lane names
  const int r = r0 + 8 * (m >> 1) + (lane & 7);
  tf32x3::ldmatrix_x4(b[0][0], b[0][1], b[1][0], b[1][1],
                      tile + at<LD>(r, 8 * d + 4 * (m & 1)));
}

// the 64 threads of pair p (barrier 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;" ::"r"(p + 1) : "memory");
}

// the (16, 32) slice of a pair, (row g, column t) A fragment of k8 step
// kk, in one ldmatrix
__device__ __forceinline__ tf32x3::FragA slice_a(const float* sl, int kk,
                                                 int lane) {
  const int m = lane >> 3;
  uint32_t a0, a1, a2, a3;
  tf32x3::ldmatrix_x4(a0, a1, a2, a3,
                      sl + ((lane & 7) + 8 * (m & 1)) * LDS + kk +
                          4 * (m >> 1));
  return tf32x3::split_a(__uint_as_float(a0), __uint_as_float(a1),
                         __uint_as_float(a2), __uint_as_float(a3));
}

// a warp's 16 x 16 accumulator (two n fragments) into the pair's slice at
// columns col0 + [0, 16)
__device__ __forceinline__ void store_slice(float* sl, const float (&x)[2][4],
                                            int col0, int g, int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* p = sl + g * LDS + col0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(p + 8 * LDS) = make_float2(x[j][2], x[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dq, float* __restrict__ delta, int64_t S,
              int64_t Sk, int64_t H, int causal, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  uint4* qh = reinterpret_cast<uint4*>(smem);  // q^ planes
  uint4* ql = qh + L::FRAG;
  uint4* gh = ql + L::FRAG;                     // dO planes
  uint4* gl = gh + L::FRAG;
  float* ring = reinterpret_cast<float*>(gl + L::FRAG);  // 2 x (k, v)
  float* dss = ring + 4 * L::TILEF;             // [PAIRS][16][LDS] dS
  float* rl = dss + PAIRS * L::SLICE;           // [ROWS] lse
  float* rd = rl + ROWS;                        // [ROWS] D
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, pair = warp >> 1, half = warp & 1;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the heaviest causal q blocks are issued first
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * ROWS;
  const int64_t row = H * D, base = b * S * row + h * D;  // q, o, dO, dq
  const int64_t kbase = b * Sk * row + h * D;              // k, v
  const int64_t q_end = q0 + ROWS < S ? q0 + ROWS : S;
  const int64_t k_end = causal ? q_end : Sk;  // keys the block's rows need
  const int ntiles = (int)((k_end + TILE - 1) / TILE);

  auto load_kv = [&](int s, int64_t k0) {
    float* st = ring + 2 * s * L::TILEF;
    load_tile<D>(st, k + kbase, k0, Sk, row);
    load_tile<D>(st + L::TILEF, v + kbase, k0, Sk, row);
  };
  load_kv(0, 0);
  tf32x3::cp_async_commit();

  // D_i of the block's rows, a warp a row: lane sums d = lane + 32 n in
  // order, then a fixed butterfly across the lanes
  for (int r = warp; r < ROWS; r += WARPS) {
    const int64_t qp = q0 + r;
    float acc = 0.0f;
    if (qp < S) {
      const float* orow = o + base + qp * row;
      const float* drow = dout + base + qp * row;
      for (int d = lane; d < D; d += 32) acc = fmaf(drow[d], orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      rd[r] = acc;
      rl[r] = qp < S ? lse[bh * S + qp] : 0.0f;
      if (qp < S) delta[bh * S + qp] = acc;
    }
  }
  split_rows<D>(qh, ql, q + base, q0, S, row, scale);
  split_rows<D>(gh, gl, dout + base, q0, S, row, 1.0f);
  __syncthreads();

  // the pair's rows q0 + 16 pair + [0, 16); in the accumulator layout a
  // thread holds rows g (elements 0, 1) and g + 8 (elements 2, 3)
  const int64_t qp0 = q0 + 16 * pair;
  const bool active = qp0 < S;
  const float lr[2] = {rl[16 * pair + g], rl[16 * pair + g + 8]};
  const float dr[2] = {rd[16 * pair + g], rd[16 * pair + g + 8]};
  const int fa = pair * L::NKS * 32 + lane;  // the lane's fragment words
  float* ds = dss + pair * L::SLICE;
  float acc[L::NH][4];
#pragma unroll
  for (int j = 0; j < L::NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = (int64_t)it * TILE;
    // tile it has landed and every warp is done with tile it - 1, whose
    // buffer the next load fills while this tile is multiplied
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_kv((it + 1) & 1, k0 + TILE);
    tf32x3::cp_async_commit();
    // a tile wholly above the pair's diagonal adds exact zeros
    if (!active || (causal && k0 > qp0 + 15)) continue;
    const float* kt = ring + 2 * (it & 1) * L::TILEF;
    const float* vt = kt + L::TILEF;

    // s = q^ k^T and dP = dO v^T of the pair's rows and the warp's 16 keys
    // of the tile, the even and the odd k8 steps apart
    float s[2][2][4], dp[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = dp[i][j][e] = 0.0f;
#pragma unroll
    for (int d = 0; d < L::NKS; ++d) {
      const tf32x3::FragA aq = frag_a(qh, ql, fa + 32 * d);
      const tf32x3::FragA ag = frag_a(gh, gl, fa + 32 * d);
      uint32_t kb[2][2], vb[2][2];
      tile_b2<LD>(kt, 16 * half, d, lane, kb);
      tile_b2<LD>(vt, 16 * half, d, lane, vb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tf32x3::mma_tf32x3(s[d & 1][j], aq,
                           tf32x3::split_b(__uint_as_float(kb[j][0]),
                                           __uint_as_float(kb[j][1])));
        tf32x3::mma_tf32x3(dp[d & 1][j], ag,
                           tf32x3::split_b(__uint_as_float(vb[j][0]),
                                           __uint_as_float(vb[j][1])));
      }
    }
    // dS = P o (dP - D), P = exp(s - lse); keys at or past Sk (column
    // past) give P = 0, and key column c lies above row r's diagonal where
    // c - r > diag; only a tile that reaches past either is masked
    const int past = (int)(Sk - k0 < TILE ? Sk - k0 : TILE);
    const int diag = (int)(qp0 - k0 < TILE ? qp0 - k0 : TILE);
    const bool edge = past < TILE || (causal && diag < TILE - 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * half + 8 * j + 2 * t + (e & 1);
        float x = s[0][j][e] + s[1][j][e];
        float p;
        if (edge) {
          if (causal && c - (g + 8 * (e >> 1)) > diag) x = kNegInf;
          p = c < past ? expf(x - lr[e >> 1]) : 0.0f;
        } else {
          p = expf(x - lr[e >> 1]);
        }
        s[0][j][e] = p * (dp[0][j][e] + dp[1][j][e] - dr[e >> 1]);
      }
    store_slice(ds, s[0], 16 * half, g, t);
    pair_sync(pair);

    // dQ[:, the warp's half of D] += dS k over the tile's keys in order
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 8) {
      const tf32x3::FragA a = slice_a(ds, kk, lane);
      float kr[L::NH][2];
#pragma unroll
      for (int j = 0; j < L::NH; ++j) {
        const int c = half * (D / 2) + 8 * j + g;
        kr[j][0] = kt[at<LD>(kk + t, c)];
        kr[j][1] = kt[at<LD>(kk + t + 4, c)];
      }
#pragma unroll
      for (int j = 0; j < L::NH; ++j)
        tf32x3::mma_tf32x3(acc[j], a, tf32x3::split_b(kr[j][0], kr[j][1]));
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = qp0 + g + 8 * r;
    if (qp >= S) continue;
    float* out = dq + base + qp * row + half * (D / 2) + 2 * t;
#pragma unroll
    for (int j = 0; j < L::NH; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int64_t S, int64_t Sk, int64_t H,
                int causal, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  uint4* kh = reinterpret_cast<uint4*>(smem);  // k planes
  uint4* kl = kh + L::FRAG;
  uint4* vh = kl + L::FRAG;                     // v planes
  uint4* vl = vh + L::FRAG;
  float* ring = reinterpret_cast<float*>(vl + L::FRAG);  // 2 x (q, dO)
  float* pts = ring + 4 * L::TILEF;             // [PAIRS][16][LDS] P^T
  float* dts = pts + PAIRS * L::SLICE;          // [PAIRS][16][LDS] dS^T
  float* stat = dts + PAIRS * L::SLICE;         // 2 x ([TILE] lse, [TILE] D)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, pair = warp >> 1, half = warp & 1;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // key block 0 meets every query tile: the heaviest blocks are issued first
  const int64_t k0 = (int64_t)blockIdx.y * ROWS;
  const int64_t row = H * D, base = b * S * row + h * D;  // q, dO
  const int64_t kbase = b * Sk * row + h * D;              // k, v, dk, dv
  // the query tiles with a row at or past the block's first key
  const int first = causal ? (int)(k0 / TILE) : 0;
  const int ntiles = (int)((S + TILE - 1) / TILE) - first;

  auto load_q = [&](int s, int64_t q0) {
    float* st = ring + 2 * s * L::TILEF;
    load_tile<D>(st, q + base, q0, S, row);
    load_tile<D>(st + L::TILEF, dout + base, q0, S, row);
    if (tid < 2 * TILE) {
      const int64_t qp = q0 + tid % TILE;
      const bool in = qp < S;
      tf32x3::cp_async4(stat + 2 * TILE * s + tid,
                        (tid < TILE ? lse : delta) + bh * S + (in ? qp : 0),
                        in);
    }
  };
  load_q(0, (int64_t)first * TILE);
  tf32x3::cp_async_commit();
  split_rows<D>(kh, kl, k + kbase, k0, Sk, row, 1.0f);
  split_rows<D>(vh, vl, v + kbase, k0, Sk, row, 1.0f);

  // the pair's keys k0 + 16 pair + [0, 16): rows of the accumulators
  const int64_t kp0 = k0 + 16 * pair;
  const bool active = kp0 < Sk;
  const int fa = pair * L::NKS * 32 + lane;
  float* pt = pts + pair * L::SLICE;
  float* dt = dts + pair * L::SLICE;
  float ak[L::NH][4], av[L::NH][4];
#pragma unroll
  for (int j = 0; j < L::NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t q0 = (int64_t)(first + it) * TILE;
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_q((it + 1) & 1, q0 + TILE);
    tf32x3::cp_async_commit();
    // a tile whose rows all lie above the pair's first key adds exact zeros
    if (!active || (causal && q0 + TILE - 1 < kp0)) continue;
    const float* qt = ring + 2 * (it & 1) * L::TILEF;
    const float* gt = qt + L::TILEF;
    const float* sl = stat + 2 * TILE * (it & 1);  // lse of the tile's rows
    const float* sd = sl + TILE;                   // D of the tile's rows

    // s^T = k q^T and dP^T = v dO^T: the pair's keys x the warp's 16 query
    // rows of the tile, the even and the odd k8 steps apart
    float s[2][2][4], dp[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = dp[i][j][e] = 0.0f;
#pragma unroll
    for (int d = 0; d < L::NKS; ++d) {
      const tf32x3::FragA ka = frag_a(kh, kl, fa + 32 * d);
      const tf32x3::FragA va = frag_a(vh, vl, fa + 32 * d);
      uint32_t qb[2][2], gb[2][2];
      tile_b2<LD>(qt, 16 * half, d, lane, qb);
      tile_b2<LD>(gt, 16 * half, d, lane, gb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tf32x3::mma_tf32x3(s[d & 1][j], ka,
                           tf32x3::split_b(__uint_as_float(qb[j][0]) * scale,
                                           __uint_as_float(qb[j][1]) * scale));
        tf32x3::mma_tf32x3(dp[d & 1][j], va,
                           tf32x3::split_b(__uint_as_float(gb[j][0]),
                                           __uint_as_float(gb[j][1])));
      }
    }
    // P^T and dS^T = P^T o (dP^T - D); query rows at or past S (column
    // past) give P = 0, and key row r lies past column c's diagonal where
    // r - c > diag; only a tile that reaches past either is masked
    const int past = (int)(S - q0 < TILE ? S - q0 : TILE);
    const int diag = (int)(q0 - kp0 < 16 ? q0 - kp0 : 16);
    const bool edge = past < TILE || (causal && diag < 15);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * half + 8 * j + 2 * t + (e & 1);
        float x = s[0][j][e] + s[1][j][e];
        float p;
        if (edge) {
          if (causal && g + 8 * (e >> 1) - c > diag) x = kNegInf;
          p = c < past ? expf(x - sl[c]) : 0.0f;
        } else {
          p = expf(x - sl[c]);
        }
        s[0][j][e] = p;
        dp[0][j][e] = p * (dp[0][j][e] + dp[1][j][e] - sd[c]);
      }
    store_slice(pt, s[0], 16 * half, g, t);
    store_slice(dt, dp[0], 16 * half, g, t);
    pair_sync(pair);

    // dV += P^T dO and dK += dS^T q^ in the warp's half of D, over the
    // tile's rows in order
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 8) {
      const tf32x3::FragA ap = slice_a(pt, kk, lane);
      const tf32x3::FragA as = slice_a(dt, kk, lane);
      float gr[L::NH][2], qr[L::NH][2];
#pragma unroll
      for (int j = 0; j < L::NH; ++j) {
        const int c = half * (D / 2) + 8 * j + g;
        gr[j][0] = gt[at<LD>(kk + t, c)];
        gr[j][1] = gt[at<LD>(kk + t + 4, c)];
        qr[j][0] = qt[at<LD>(kk + t, c)] * scale;
        qr[j][1] = qt[at<LD>(kk + t + 4, c)] * scale;
      }
#pragma unroll
      for (int j = 0; j < L::NH; ++j) {
        tf32x3::mma_tf32x3(av[j], ap, tf32x3::split_b(gr[j][0], gr[j][1]));
        tf32x3::mma_tf32x3(ak[j], as, tf32x3::split_b(qr[j][0], qr[j][1]));
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t kp = kp0 + g + 8 * r;
    if (kp >= Sk) continue;
    const int64_t at_row = kbase + kp * row + half * (D / 2) + 2 * t;
#pragma unroll
    for (int j = 0; j < L::NH; ++j) {
      *reinterpret_cast<float2*>(dk + at_row + 8 * j) =
          make_float2(ak[j][2 * r], ak[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at_row + 8 * j) =
          make_float2(av[j][2 * r], av[j][2 * r + 1]);
    }
  }
}

template <int D>
int run_dq(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* delta,
           int64_t B, int64_t S, int64_t Sk, int64_t H, int causal,
           cudaStream_t st) {
  const size_t bytes = Layout<D>::DQ;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dq_kernel<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + ROWS - 1) / ROWS));
  bwd_dq_kernel<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, o, dout, lse, dq, delta, S, Sk, H, causal,
      elem::head_scale<float>(D));
  return (int)cudaGetLastError();
}

template <int D>
int run_dkdv(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* delta,
             float* dk, float* dv, int64_t B, int64_t S, int64_t Sk,
             int64_t H, int causal, cudaStream_t st) {
  const size_t bytes = Layout<D>::DKDV;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dkdv_kernel<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sk + ROWS - 1) / ROWS));
  bwd_dkdv_kernel<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Sk, H, causal,
      elem::head_scale<float>(D));
  return (int)cudaGetLastError();
}

// dynamic shared memory bytes, registers a thread and resident blocks an
// SM of one instance
template <auto Kernel>
int occupancy(size_t bytes, int64_t* out) {
  cudaError_t err = tf32x3::set_shared_memory<Kernel>((int)bytes);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, Kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                        THREADS, bytes);
  out[0] = (int64_t)bytes;
  out[1] = fa.numRegs;
  out[2] = blocks;
  return (int)err;
}

template <int D>
int occupancy_of(int64_t kernel, int64_t* out) {
  return kernel == 0
             ? occupancy<bwd_dq_kernel<D>>(Layout<D>::DQ, out)
             : occupancy<bwd_dkdv_kernel<D>>(Layout<D>::DKDV, out);
}

}  // namespace

// q, o, dout, dq: (B, S, H, D) and k, v: (B, Sk, H, D) f32, contiguous;
// lse, delta: (B, H, S) f32; D in {16, 32, 64, 128}; causal 0 or 1, and a
// causal call has Sk == S.  Writes dq and delta.
extern "C" int smof_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int64_t B,
    int64_t S, int64_t Sk, int64_t H, int64_t D, int64_t causal,
    void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)o,
              *df = (const float*)dout, *lf = (const float*)lse;
  float *dqf = (float*)dq, *delf = (float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dq<16>(qf, kf, vf, of, df, lf, dqf, delf, B, S, Sk, H, c,
                        st);
    case 32:
      return run_dq<32>(qf, kf, vf, of, df, lf, dqf, delf, B, S, Sk, H, c,
                        st);
    case 64:
      return run_dq<64>(qf, kf, vf, of, df, lf, dqf, delf, B, S, Sk, H, c,
                        st);
    case 128:
      return run_dq<128>(qf, kf, vf, of, df, lf, dqf, delf, B, S, Sk, H, c,
                         st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, dout: (B, S, H, D) and k, v, dk, dv: (B, Sk, H, D) f32, contiguous;
// lse, delta (the dq kernel's): (B, H, S) f32.  Writes dk and dv.
extern "C" int smof_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t B,
    int64_t S, int64_t Sk, int64_t H, int64_t D, int64_t causal,
    void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *df = (const float*)dout,
              *lf = (const float*)lse, *delf = (const float*)delta;
  float *dkf = (float*)dk, *dvf = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dkdv<16>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, Sk, H, c,
                          st);
    case 32:
      return run_dkdv<32>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, Sk, H, c,
                          st);
    case 64:
      return run_dkdv<64>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, Sk, H, c,
                          st);
    case 128:
      return run_dkdv<128>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, Sk, H,
                           c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[0..2]: dynamic shared memory bytes, registers a thread and resident
// blocks an SM of the dq (kernel 0) or dkdv (kernel 1) instance at head
// width D, on the current device.
extern "C" int smof_flash_attention_bwd_occupancy(int64_t D, int64_t kernel,
                                                  int64_t* out) {
  switch (D) {
    case 16: return occupancy_of<16>(kernel, out);
    case 32: return occupancy_of<32>(kernel, out);
    case 64: return occupancy_of<64>(kernel, out);
    case 128: return occupancy_of<128>(kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
