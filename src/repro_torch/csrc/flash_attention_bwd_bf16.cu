// flash_attention_bwd_bf16: the gradient of flash_attention_lse_bf16
// (flash_attention_bf16.cu) on bf16 operands, as two kernels on q, o, dO of
// shape (B, S, H, D) and k, v of shape (B, Sk, H, D) bf16 (o f32: the
// forward's output before its rounding) and lse, delta of shape (B, H, S)
// f32, the KV heads already repeated to H; a causal call has Sk == S, a
// non-causal one keys of their own length (the encoder-decoder's cross
// attention).  They compute what the f32 pair
// (flash_attention_bwd.cu) computes, in f32 from the bf16 operands:
//   q^ = bf16(q bf16(D^-1/2)), s = q^ k^T [causal mask -2^30],
//   P = exp(s - lse), dV = P^T dO, dP = dO v^T, D_i = rowsum(dO o O) (O in
//   f32, as autodiff of the plain route takes it),
//   dS = P o (dP - D), dQ = bf16(dS k bf16(D^-1/2)), dK = bf16(dS^T q^),
//   dV rounded once; lse and D stay f32.
//
// They replace the bf16 instances of the f32 body (flash_attention_bwd.cu's
// bwd_dq_kernel and bwd_dkdv_kernel, once templated on T = bf16), which
// widened every bf16 tile to f32 as it was staged and ran all seven products
// on the 3xTF32 split: the gradient XLA takes of the reference's
// chunked_attention in bf16
// (src/repro/models/attention.py:68; the TPU package has no backward
// kernel).
//
// Bound on the H100: at yi-6b's train shape (S = 1024, D = 128, causal) the
// pair does 7 products of S (S + 1) / 2 D multiply-adds a (b, h) on about 9
// S D bf16 values: bound by the tensor cores.  This design runs each product
// on the bf16 tensor cores (mma.sync m16n8k16, f32 accumulation, 989 TFLOP/s
// dense):
// - s = q^ k^T and dP = dO v^T have two bf16 operands: one native product
//   each, every bf16 x bf16 product exact in f32.
// - dQ = dS k, dV = P^T dO and dK = dS^T q^ multiply an f32 intermediate by
//   a bf16 operand.  P and dS are split in registers into PIECES = 2 bf16
//   pieces, p1 = bf16(p), p2 = bf16(p - p1) (p - p1 exact in f32), and the
//   product is p2 b + p1 b into one f32 accumulator, the small piece first.
//   Two pieces carry 16 of p's 24 bits and leave at most 2^-16 of each
//   term; tests/test_torch_bf16.py emulates the sums and holds two pieces
//   (and three, which carry p exactly) to the ulp rule chip_smoke.py's
//   phase 4 holds these kernels to, at every one of its shapes.
// So dq runs 4 bf16 products (s, dP, 2 x dQ) and dkdv 6 (s, dP, 2 x dV,
// 2 x dK): the pair's own bound is 10 S (S + 1) / 2 D 2 operations a
// (b, h) at 989 TFLOP/s.  No atomics: dq recomputes s and dP so that dQ
// has one writer, every sum is taken in a fixed order, and two launches are
// bit for bit.
//
// Both kernels: 4 warps (128 threads) a block; warp w owns 16 rows of the
// block's 64 stationary rows (query rows in dq, keys in dkdv) and walks
// tiles of 32 rows of the moving operand (keys in dq, query rows in dkdv).
// The bf16 tiles go through a 3-stage cp.async ring (16-byte copies of 8
// values, rows past S or Sk zero-filled), two tiles in flight while the warps
// multiply the third.  Per tile a warp computes its 16 x 32 scores and dP
// over all of D (8 accumulator chains of m16n8k16 products), masks them
// (only a tile that reaches past S, past Sk or across a diagonal), forms P
// and dS in the accumulators' layout and passes them on in registers: two
// adjacent n8 accumulator tiles are the A fragment of a k16 step over the
// same 32 rows, as FA-2 does, so no slice goes through shared memory.  dkdv
// takes s^T = k q^T and dP^T = v dO^T, so that P^T and dS^T come out with
// keys as rows.  The warp then adds its 16 x D block of dQ (or of dK and
// dV) over the tile's rows in order.  Fragments come from shared memory
// through ldmatrix: the stationary rows and the moving tile as A and B
// operands of s and dP (rows = D-major 16-byte chunks), the moving tile
// again with .trans as the B operand of the second product (k in dq, dO and
// q^ in dkdv).  Rows are D
// bf16 values, unpadded, their 16-byte chunks XOR-swizzled by row (chunk c
// of row r at c ^ (r & 7) from D = 64 up, c ^ ((r / (8 / C)) % C) below, C
// = D / 8 chunks a row), which keeps the 8 rows of every ldmatrix, both
// plain and transposed, in distinct banks.  q^ in dkdv is made in place:
// each thread scales the chunks it copied once its copies have landed,
// before the barrier that hands the tile to the warps.  The heaviest causal
// blocks are issued first.
//
// Shared memory and occupancy at D = 128: the stationary rows 32,768 bytes
// (two operands of 64 x 128 bf16), the ring 49,152 (3 stages of two 32-row
// tiles), D of the rows 256 (dq) or lse and D of 3 tiles 768 (dkdv): 82,176
// bytes (dq) and 82,688 (dkdv), a third of the f32 body's 206,336 / 215,552
// (its hi / lo split planes alone took 131,072).  Two blocks fit an SM
// (__launch_bounds__(128, 2): up to 255 registers a thread), 8 warps as the
// f32 body's one block; the accumulators take D / 2 registers a thread in
// dq and D in dkdv.  Phase 2 of chip_smoke.py prints each instance's
// shared memory, registers and blocks an SM, and fails on a spill.
//
// Rows past S (query rows) or Sk (keys) are read as zeros and never
// written; a key past Sk gets a probability of exactly 0 (dq), a query row
// past S a P of 0 (dkdv); the dkdv grid runs ceil(Sk / 64) key blocks over
// all S query rows; the causal mask is -2^30, as the forward's; the
// exponentials are full expf.
// The dq kernel writes D_i of its rows, which the dkdv kernel (launched
// after it on the same stream) reads.  The staging, fragment, product and
// split helpers are bf16_mma.cuh's, shared with the bf16 forward pair; of
// tf32x3.cuh only the copy and launch helpers are used, none of its split.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bf16_mma.cuh"
#include "elem.cuh"
#include "tf32x3.cuh"

namespace {

// bf16, WARPS = 4, THREADS, PIECES = 2 (of P and dS), and the helpers
using namespace bf16_mma;

constexpr int ROWS = 16 * WARPS;  // query rows of a dq block, keys of dkdv's
constexpr int TILE = 32;          // keys of a dq tile, query rows of dkdv's
constexpr int STAGES = 3;         // tiles in the cp.async ring
constexpr float kNegInf = -1073741824.0f;  // -2^30, the forward's mask

template <int D>
struct Layout {
  static constexpr int C = D / 8;     // 16-byte chunks of a row
  static constexpr int KS = D / 16;   // k16 steps over D
  static constexpr int NT = D / 8;    // n8 tiles over D
  static constexpr int STAT = ROWS * D;   // bf16 values of a stationary operand
  static constexpr int TILEV = TILE * D;  // bf16 values of a moving tile
  static constexpr size_t RING = 2 * STAGES * TILEV * sizeof(bf16);
  // q^, dO of the rows; ring of STAGES x (k, v); D of the rows
  static constexpr size_t DQ =
      2 * STAT * sizeof(bf16) + RING + ROWS * sizeof(float);
  // k, v of the keys; ring of STAGES x (q^, dO); STAGES x (lse, D) of a tile
  static constexpr size_t DKDV =
      2 * STAT * sizeof(bf16) + RING + STAGES * 2 * TILE * sizeof(float);
};

// q^ in place: the chunks of a staged tile this thread copied, times scale
// (its own copies have landed once it has waited for their group)
template <int D>
__device__ __forceinline__ void scale_tile(bf16* tile, float scale) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < TILE * C; i += THREADS) {
    uint4* p = reinterpret_cast<uint4*>(tile + chunk<C>(i / C, i % C));
    *p = scaled(*p, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ o,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            bf16* __restrict__ dq, float* __restrict__ delta, int64_t S,
            int64_t Sk, int64_t H, int causal, float scale) {
  using L = Layout<D>;
  constexpr int C = L::C;
  extern __shared__ uint4 smem_bf16[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // [ROWS][D] q^
  bf16* gs = qs + L::STAT;                         // [ROWS][D] dO
  bf16* ring = gs + L::STAT;                       // STAGES x (k, v)
  float* rd = reinterpret_cast<float*>(ring + 2 * STAGES * L::TILEV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the heaviest causal q blocks are issued first
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * ROWS;
  const int64_t row = H * D, base = b * S * row + h * D;  // q, o, dO, dq
  const int64_t kbase = b * Sk * row + h * D;              // k, v
  const int64_t q_end = q0 + ROWS < S ? q0 + ROWS : S;
  const int64_t k_end = causal ? q_end : Sk;  // keys the block's rows need
  const int ntiles = (int)((k_end + TILE - 1) / TILE);

  auto load_kv = [&](int it) {
    bf16* st = ring + 2 * (it % STAGES) * L::TILEV;
    load_rows<D>(st, k + kbase, (int64_t)it * TILE, TILE, Sk, row);
    load_rows<D>(st + L::TILEV, v + kbase, (int64_t)it * TILE, TILE, Sk,
                 row);
  };
  load_rows<D>(gs, dout + base, q0, ROWS, S, row);
  load_kv(0);
  tf32x3::cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    tf32x3::cp_async_commit();
  }

  // q^ of the block's rows, rounded once as the plain route rounds it
  for (int i = tid; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S)
      u = scaled(*reinterpret_cast<const uint4*>(q + base + (q0 + r) * row +
                                                 8 * c),
                 scale);
    *reinterpret_cast<uint4*>(qs + chunk<C>(r, c)) = u;
  }
  // D_i of the block's rows, a warp a row: lane sums d = lane + 32 n in
  // order, then a fixed butterfly across the lanes
  for (int r = warp; r < ROWS; r += WARPS) {
    const int64_t qp = q0 + r;
    float acc = 0.0f;
    if (qp < S) {
      const float* orow = o + base + qp * row;
      const bf16* drow = dout + base + qp * row;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(__bfloat162float(drow[d]), orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      rd[r] = acc;
      if (qp < S) delta[bh * S + qp] = acc;
    }
  }
  __syncthreads();

  // the warp's rows q0 + 16 warp + [0, 16); in the accumulator layout a
  // thread holds rows g (elements 0, 1) and g + 8 (elements 2, 3)
  const int r0 = 16 * warp;
  const int64_t qp0 = q0 + r0;
  const bool active = qp0 < S;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qp = qp0 + g + 8 * i;
    lr[i] = qp < S ? lse[bh * S + qp] : 0.0f;
    dr[i] = rd[r0 + g + 8 * i];
  }
  float acc[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = (int64_t)it * TILE;
    // tile it has landed and every warp is done with tile it - 1, whose
    // stage the load of tile it + STAGES - 1 fills
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    tf32x3::cp_async_commit();
    // a tile wholly above the warp's diagonal adds exact zeros
    if (!active || (causal && k0 > qp0 + 15)) continue;
    const bf16* kt = ring + 2 * (it % STAGES) * L::TILEV;
    const bf16* vt = kt + L::TILEV;

    // s = q^ k^T and dP = dO v^T of the warp's rows and the tile's 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks) {
      uint32_t aq[4], ag[4];
      frag_a<C>(aq, qs, r0, ks, lane);
      frag_a<C>(ag, gs, r0, ks, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t kb[4], vb[4];
        frag_b<C>(kb, kt, nb, ks, lane);
        frag_b<C>(vb, vt, nb, ks, lane);
        mma(s[2 * nb], aq, kb[0], kb[1]);
        mma(s[2 * nb + 1], aq, kb[2], kb[3]);
        mma(dp[2 * nb], ag, vb[0], vb[1]);
        mma(dp[2 * nb + 1], ag, vb[2], vb[3]);
      }
    }
    // dS = P o (dP - D), P = exp(s - lse); keys at or past Sk (column
    // past) give P = 0, and key column c lies above row r's diagonal where
    // c - r > diag; only a tile that reaches past either is masked
    const int past = (int)(Sk - k0 < TILE ? Sk - k0 : TILE);
    const int diag = (int)(qp0 - k0 < TILE ? qp0 - k0 : TILE);
    const bool edge = past < TILE || (causal && diag < TILE - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        float p;
        if (edge) {
          if (causal && c - (g + 8 * (e >> 1)) > diag) x = kNegInf;
          p = c < past ? expf(x - lr[e >> 1]) : 0.0f;
        } else {
          p = expf(x - lr[e >> 1]);
        }
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }

    // dQ += dS k over the tile's keys in order, dS in its pieces
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t a[PIECES][4];
      split(s[2 * kb], s[2 * kb + 1], a);
#pragma unroll
      for (int dn = 0; dn < L::NT / 2; ++dn) {
        uint32_t bk[4];
        frag_bt<C>(bk, kt, kb, dn, lane);
#pragma unroll
        for (int i = PIECES - 1; i >= 0; --i) {
          mma(acc[2 * dn], a[i], bk[0], bk[1]);
          mma(acc[2 * dn + 1], a[i], bk[2], bk[3]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qp = qp0 + g + 8 * i;
    if (qp >= S) continue;
    bf16* out = dq + base + qp * row + 2 * t;
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
      elem::store2(out + 8 * j, acc[j][2 * i] * scale,
                   acc[j][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t S,
              int64_t Sk, int64_t H, int causal, float scale) {
  using L = Layout<D>;
  constexpr int C = L::C;
  extern __shared__ uint4 smem_bf16[];
  bf16* kss = reinterpret_cast<bf16*>(smem_bf16);  // [ROWS][D] k
  bf16* vss = kss + L::STAT;                        // [ROWS][D] v
  bf16* ring = vss + L::STAT;                       // STAGES x (q^, dO)
  float* stat = reinterpret_cast<float*>(ring + 2 * STAGES * L::TILEV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // key block 0 meets every query tile: the heaviest blocks are issued first
  const int64_t k0 = (int64_t)blockIdx.y * ROWS;
  const int64_t row = H * D, base = b * S * row + h * D;  // q, dO
  const int64_t kbase = b * Sk * row + h * D;              // k, v, dk, dv
  // the query tiles with a row at or past the block's first key
  const int first = causal ? (int)(k0 / TILE) : 0;
  const int ntiles = (int)((S + TILE - 1) / TILE) - first;

  auto load_q = [&](int it) {
    const int st = it % STAGES;
    const int64_t q0 = (int64_t)(first + it) * TILE;
    bf16* qt = ring + 2 * st * L::TILEV;
    load_rows<D>(qt, q + base, q0, TILE, S, row);
    load_rows<D>(qt + L::TILEV, dout + base, q0, TILE, S, row);
    if (tid < 2 * TILE) {
      const int64_t qp = q0 + tid % TILE;
      const bool in = qp < S;
      tf32x3::cp_async4(stat + 2 * TILE * st + tid,
                        (tid < TILE ? lse : delta) + bh * S + (in ? qp : 0),
                        in);
    }
  };
  load_rows<D>(kss, k + kbase, k0, ROWS, Sk, row);
  load_rows<D>(vss, v + kbase, k0, ROWS, Sk, row);
  load_q(0);
  tf32x3::cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < ntiles) load_q(s);
    tf32x3::cp_async_commit();
  }

  // the warp's keys k0 + 16 warp + [0, 16): rows of the accumulators
  const int r0 = 16 * warp;
  const int64_t kp0 = k0 + r0;
  const bool active = kp0 < Sk;
  float ak[L::NT][4], av[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t q0 = (int64_t)(first + it) * TILE;
    bf16* qt = ring + 2 * (it % STAGES) * L::TILEV;
    tf32x3::cp_async_wait<STAGES - 2>();
    scale_tile<D>(qt, scale);
    __syncthreads();
    if (it + STAGES - 1 < ntiles) load_q(it + STAGES - 1);
    tf32x3::cp_async_commit();
    // a tile whose rows all lie above the warp's first key adds exact zeros
    if (!active || (causal && q0 + TILE - 1 < kp0)) continue;
    const bf16* gt = qt + L::TILEV;
    const float* sl = stat + 2 * TILE * (it % STAGES);  // lse of the rows
    const float* sd = sl + TILE;                         // D of the rows

    // s^T = k q^T and dP^T = v dO^T: the warp's keys x the tile's 32 rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks) {
      uint32_t ka[4], va[4];
      frag_a<C>(ka, kss, r0, ks, lane);
      frag_a<C>(va, vss, r0, ks, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t qb[4], gb[4];
        frag_b<C>(qb, qt, nb, ks, lane);
        frag_b<C>(gb, gt, nb, ks, lane);
        mma(s[2 * nb], ka, qb[0], qb[1]);
        mma(s[2 * nb + 1], ka, qb[2], qb[3]);
        mma(dp[2 * nb], va, gb[0], gb[1]);
        mma(dp[2 * nb + 1], va, gb[2], gb[3]);
      }
    }
    // P^T and dS^T = P^T o (dP^T - D); query rows at or past S (column
    // past) give P = 0, and key row r lies past column c's diagonal where
    // r - c > diag; only a tile that reaches past either is masked
    const int past = (int)(S - q0 < TILE ? S - q0 : TILE);
    const int diag = (int)(q0 - kp0 < 16 ? q0 - kp0 : 16);
    const bool edge = past < TILE || (causal && diag < 15);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        float p;
        if (edge) {
          if (causal && g + 8 * (e >> 1) - c > diag) x = kNegInf;
          p = c < past ? expf(x - sl[c]) : 0.0f;
        } else {
          p = expf(x - sl[c]);
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sd[c]);
      }

    // dV += P^T dO and dK += dS^T q^ over the tile's rows in order, P^T and
    // dS^T in their pieces
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t ap[PIECES][4], as[PIECES][4];
      split(s[2 * kb], s[2 * kb + 1], ap);
      split(dp[2 * kb], dp[2 * kb + 1], as);
#pragma unroll
      for (int dn = 0; dn < L::NT / 2; ++dn) {
        uint32_t bg[4], bq[4];
        frag_bt<C>(bg, gt, kb, dn, lane);
        frag_bt<C>(bq, qt, kb, dn, lane);
#pragma unroll
        for (int i = PIECES - 1; i >= 0; --i) {
          mma(av[2 * dn], ap[i], bg[0], bg[1]);
          mma(av[2 * dn + 1], ap[i], bg[2], bg[3]);
          mma(ak[2 * dn], as[i], bq[0], bq[1]);
          mma(ak[2 * dn + 1], as[i], bq[2], bq[3]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kp = kp0 + g + 8 * i;
    if (kp >= Sk) continue;
    const int64_t at_row = kbase + kp * row + 2 * t;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      elem::store2(dk + at_row + 8 * j, ak[j][2 * i], ak[j][2 * i + 1]);
      elem::store2(dv + at_row + 8 * j, av[j][2 * i], av[j][2 * i + 1]);
    }
  }
}

template <int D>
int run_dq(const bf16* q, const bf16* k, const bf16* v, const float* o,
           const bf16* dout, const float* lse, bf16* dq, float* delta,
           int64_t B, int64_t S, int64_t Sk, int64_t H, int causal,
           cudaStream_t st) {
  const size_t bytes = Layout<D>::DQ;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dq_bf16<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + ROWS - 1) / ROWS));
  bwd_dq_bf16<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, o, dout, lse, dq, delta, S, Sk, H, causal,
      elem::head_scale<bf16>(D));
  return (int)cudaGetLastError();
}

template <int D>
int run_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
             const float* lse, const float* delta, bf16* dk, bf16* dv,
             int64_t B, int64_t S, int64_t Sk, int64_t H, int causal,
             cudaStream_t st) {
  const size_t bytes = Layout<D>::DKDV;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dkdv_bf16<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sk + ROWS - 1) / ROWS));
  bwd_dkdv_bf16<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Sk, H, causal,
      elem::head_scale<bf16>(D));
  return (int)cudaGetLastError();
}

template <int D>
int occupancy_of(int64_t kernel, int64_t* out) {
  return kernel == 0 ? occupancy<bwd_dq_bf16<D>>(Layout<D>::DQ, out)
                     : occupancy<bwd_dkdv_bf16<D>>(Layout<D>::DKDV, out);
}

}  // namespace

// q, dout, dq: (B, S, H, D) and k, v: (B, Sk, H, D) bf16, contiguous; o:
// (B, S, H, D) f32; lse, delta: (B, H, S) f32; D in {16, 32, 64, 128};
// causal 0 or 1, and a causal call has Sk == S.  Writes dq and delta.
extern "C" int smof_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int64_t B,
    int64_t S, int64_t Sk, int64_t H, int64_t D, int64_t causal,
    void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
             *vb = (const bf16*)v, *db = (const bf16*)dout;
  const float *ob = (const float*)o, *lf = (const float*)lse;
  bf16* dqb = (bf16*)dq;
  float* delf = (float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dq<16>(qb, kb, vb, ob, db, lf, dqb, delf, B, S, Sk, H, c,
                        st);
    case 32:
      return run_dq<32>(qb, kb, vb, ob, db, lf, dqb, delf, B, S, Sk, H, c,
                        st);
    case 64:
      return run_dq<64>(qb, kb, vb, ob, db, lf, dqb, delf, B, S, Sk, H, c,
                        st);
    case 128:
      return run_dq<128>(qb, kb, vb, ob, db, lf, dqb, delf, B, S, Sk, H, c,
                         st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, dout: (B, S, H, D) and k, v, dk, dv: (B, Sk, H, D) bf16, contiguous;
// lse, delta (the dq kernel's): (B, H, S) f32.  Writes dk and dv.
extern "C" int smof_flash_attention_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t B,
    int64_t S, int64_t Sk, int64_t H, int64_t D, int64_t causal,
    void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
             *vb = (const bf16*)v, *db = (const bf16*)dout;
  const float *lf = (const float*)lse, *delf = (const float*)delta;
  bf16 *dkb = (bf16*)dk, *dvb = (bf16*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dkdv<16>(qb, kb, vb, db, lf, delf, dkb, dvb, B, S, Sk, H, c,
                          st);
    case 32:
      return run_dkdv<32>(qb, kb, vb, db, lf, delf, dkb, dvb, B, S, Sk, H, c,
                          st);
    case 64:
      return run_dkdv<64>(qb, kb, vb, db, lf, delf, dkb, dvb, B, S, Sk, H, c,
                          st);
    case 128:
      return run_dkdv<128>(qb, kb, vb, db, lf, delf, dkb, dvb, B, S, Sk, H,
                           c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[0..2]: dynamic shared memory bytes, registers a thread and resident
// blocks an SM of the dq (kernel 0) or dkdv (kernel 1) bf16 instance at head
// width D, on the current device.
extern "C" int smof_flash_attention_bwd_bf16_occupancy(int64_t D,
                                                       int64_t kernel,
                                                       int64_t* out) {
  switch (D) {
    case 16: return occupancy_of<16>(kernel, out);
    case 32: return occupancy_of<32>(kernel, out);
    case 64: return occupancy_of<64>(kernel, out);
    case 128: return occupancy_of<128>(kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
