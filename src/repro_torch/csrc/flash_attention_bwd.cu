// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// from the forward's output o and its per-row log-sum-exp lse, as two
// kernels on q, k, v, o, dO of shape (B, S, H, D) and lse, delta of shape
// (B, H, S), all f32, the KV heads already repeated to H.  With the scaled
// scores s = (q D^-1/2) k^T [causal mask -2^30]:
//   P = exp(s - lse), dV = P^T dO, dP = dO V^T, D_i = rowsum(dO o O),
//   dS = P o (dP - D), dQ = dS K D^-1/2, dK = dS^T (q D^-1/2).
//
// The TPU package has no backward kernel: XLA differentiates its plain
// chunked_attention (src/repro/models/attention.py), the Pallas kernel's own
// oracle.  These are the gradient of that function on the card, so that the
// training route runs no plain version.
//
// flash_attention_bwd_dq: one block per (b h, 64 query rows).  It writes
// D_i = rowsum(dO o O) of its rows (the dkdv kernel reads it), then walks
// the 64-key tiles at or below its diagonal, recomputes P and dP from q, k,
// v, dO and lse, and accumulates its rows of dQ in registers.
// flash_attention_bwd_dkdv: one block per (b h, 64 keys).  It walks the
// query tiles at or above its diagonal, recomputes P and dP, reads D, and
// accumulates its keys' dK and dV in registers.  It runs after the dq kernel
// on the same stream.
//
// Bound on the H100: at yi-6b's train shape (S = 1024, D = 128) the two
// kernels do 7 products of 2 S^2 D / 2 operations a (b, h) (3 in dq, 4 in
// dkdv) on about 9 S D values of 4 bytes: bound by operations.  Design: a
// simple f32 kernel, no atomics, every sum in a fixed order, so that two
// launches are bit for bit.  256 threads a block; a thread owns a 4 x 4
// micro-tile of the (64, 64) score tile (rows ty + 16 i, columns tx + 16 j)
// and a 4 x D/16 slice of its block's (64, D) accumulator (columns tx +
// 16 j), each product an FMA chain over shared memory whose rows are
// padded to D + 1 floats, so that the 16 columns a half-warp reads fall in
// 16 banks.  Rows past S are read as zeros and never written; keys past S
// get a probability of exactly 0; the causal mask is -2^30, as the forward's,
// and the exponentials are full expf.  The tensor cores (3xTF32 mma.sync
// as the forward, or wgmma) are later work.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float kNegInf = -1073741824.0f;  // -2^30, the forward's mask

template <int D>
struct Smem {
  static constexpr int LD = D + 1, LDP = 65;  // padded row strides, floats
  static constexpr int TILE = 64 * LD, SQ = 64 * LDP;
  // dq: q, dO, k, v tiles, dS, lse and D of the rows
  static constexpr size_t DQ = (4 * TILE + SQ + 2 * 64) * sizeof(float);
  // dkdv: k, v, q, dO tiles, P^T and dS^T, lse and D of the rows
  static constexpr size_t DKDV = (4 * TILE + 2 * SQ + 2 * 64) * sizeof(float);
};

// rows r0 .. r0 + 63 of a (S, row)-strided operand into a [64][D + 1] tile,
// times scale (1 or D^-1/2, one f32 product as the reference's q * scale);
// rows past S as zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int64_t r0, int64_t S, int64_t row,
                                          float scale) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * C4; idx += THREADS) {
    const int r = idx / C4, c = idx % C4 * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(src + (r0 + r) * row + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x * scale;
    d[1] = x.y * scale;
    d[2] = x.z * scale;
    d[3] = x.w * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dq, float* __restrict__ delta, int64_t S,
              int64_t H, int causal, float scale) {
  using M = Smem<D>;
  constexpr int LD = M::LD, LDP = M::LDP, NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][LD], q * D^-1/2
  float* dos = qs + M::TILE;   // [BQ][LD]
  float* ks = dos + M::TILE;   // [BK][LD]
  float* vs = ks + M::TILE;    // [BK][LD]
  float* ds = vs + M::TILE;    // [BQ][LDP]
  float* rl = ds + M::SQ;      // [BQ] lse
  float* rd = rl + BQ;         // [BQ] D
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the heaviest causal q blocks are issued first
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t row = H * D, base = b * S * row + h * D;

  load_rows<D>(qs, q + base, q0, S, row, scale);
  load_rows<D>(dos, dout + base, q0, S, row, 1.0f);
  // D_i of the block's rows, a warp a row: lane sums d = lane + 32 n in
  // order, then a fixed butterfly across the lanes
  for (int r = warp; r < BQ; r += THREADS / 32) {
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

  const int64_t q_end = q0 + BQ < S ? q0 + BQ : S;
  const int64_t k_end = causal ? q_end : S;  // keys the block's rows need
  const int ntiles = (int)((k_end + BK - 1) / BK);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = (int64_t)it * BK;
    __syncthreads();  // the last tile's k, v and dS are read
    load_rows<D>(ks, k + base, k0, S, row, 1.0f);
    load_rows<D>(vs, v + base, k0, S, row, 1.0f);
    __syncthreads();

    // s = (q D^-1/2) k^T and dP = dO v^T of the thread's micro-tile
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * LD + d];
        g[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }
    // dS = P o (dP - D), P = exp(s - lse); keys past S give P = 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int64_t qp = q0 + r, kp = k0 + c;
        const float x = causal && kp > qp ? kNegInf : s[i][j];
        const float p = kp < S ? expf(x - rl[r]) : 0.0f;
        ds[r * LDP + c] = p * (dp[i][j] - rd[r]);
      }
    __syncthreads();

    // dQ += dS k, over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[base + qp * row + tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int64_t S, int64_t H, int causal,
                float scale) {
  using M = Smem<D>;
  constexpr int LD = M::LD, LDP = M::LDP, NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [BK][LD]
  float* vs = ks + M::TILE;    // [BK][LD]
  float* qs = vs + M::TILE;    // [BQ][LD], q * D^-1/2
  float* dos = qs + M::TILE;   // [BQ][LD]
  float* pt = dos + M::TILE;   // [BK][LDP], P^T
  float* dst = pt + M::SQ;     // [BK][LDP], dS^T
  float* rl = dst + M::SQ;     // [BQ] lse
  float* rd = rl + BQ;         // [BQ] D
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // key block 0 meets every query tile: the heaviest blocks are issued first
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  const int64_t row = H * D, base = b * S * row + h * D;

  load_rows<D>(ks, k + base, k0, S, row, 1.0f);
  load_rows<D>(vs, v + base, k0, S, row, 1.0f);
  // the query tiles with a row at or past the block's first key
  const int first = causal ? (int)(k0 / BQ) : 0;
  const int nq = (int)((S + BQ - 1) / BQ);
  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.0f;

  for (int it = first; it < nq; ++it) {
    const int64_t q0 = (int64_t)it * BQ;
    __syncthreads();  // the last tile's q, dO, P^T and dS^T are read
    load_rows<D>(qs, q + base, q0, S, row, scale);
    load_rows<D>(dos, dout + base, q0, S, row, 1.0f);
    for (int r = tid; r < BQ; r += THREADS) {
      const int64_t qp = q0 + r;
      rl[r] = qp < S ? lse[bh * S + qp] : 0.0f;
      rd[r] = qp < S ? delta[bh * S + qp] : 0.0f;
    }
    __syncthreads();

    // s^T = k (q D^-1/2)^T and dP^T = v dO^T: rows are the block's keys,
    // columns the tile's query rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kb[4], vb[4], a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kb[i] = ks[(ty + 16 * i) * LD + d];
        vb[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kb[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vb[i], g[j], dp[i][j]);
        }
    }
    // P and dS = P o (dP - D); query rows past S give P = 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int64_t kp = k0 + r, qp = q0 + c;
        const float x = causal && kp > qp ? kNegInf : s[i][j];
        const float p = qp < S ? expf(x - rl[c]) : 0.0f;
        pt[r * LDP + c] = p;
        dst[r * LDP + c] = p * (dp[i][j] - rd[c]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T (q D^-1/2), over the tile's rows in order
#pragma unroll 2
    for (int c = 0; c < BQ; ++c) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pt[(ty + 16 * i) * LDP + c];
        sa[i] = dst[(ty + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = dos[c * LD + tx + 16 * j];
        const float a = qs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i][j] = fmaf(pa[i], g, av[i][j]);
          ak[i][j] = fmaf(sa[i], a, ak[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t kp = k0 + ty + 16 * i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[base + kp * row + tx + 16 * j] = ak[i][j];
      dv[base + kp * row + tx + 16 * j] = av[i][j];
    }
  }
}

template <int D>
int run_dq(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* delta,
           int64_t B, int64_t S, int64_t H, int causal, cudaStream_t st) {
  const size_t bytes = Smem<D>::DQ;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dq_kernel<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  const float scale = (float)(1.0 / std::sqrt((double)D));
  bwd_dq_kernel<D><<<grid, THREADS, bytes, st>>>(q, k, v, o, dout, lse, dq,
                                                 delta, S, H, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int run_dkdv(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* delta,
             float* dk, float* dv, int64_t B, int64_t S, int64_t H,
             int causal, cudaStream_t st) {
  const size_t bytes = Smem<D>::DKDV;
  const cudaError_t err =
      tf32x3::set_shared_memory<bwd_dkdv_kernel<D>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BK - 1) / BK));
  const float scale = (float)(1.0 / std::sqrt((double)D));
  bwd_dkdv_kernel<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq: (B, S, H, D) f32, contiguous; lse, delta: (B, H, S)
// f32; D in {16, 32, 64, 128}; causal 0 or 1.  Writes dq and delta.
extern "C" int smof_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int64_t B,
    int64_t S, int64_t H, int64_t D, int64_t causal, void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)o,
              *df = (const float*)dout, *lf = (const float*)lse;
  float *dqf = (float*)dq, *delf = (float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dq<16>(qf, kf, vf, of, df, lf, dqf, delf, B, S, H, c, st);
    case 32:
      return run_dq<32>(qf, kf, vf, of, df, lf, dqf, delf, B, S, H, c, st);
    case 64:
      return run_dq<64>(qf, kf, vf, of, df, lf, dqf, delf, B, S, H, c, st);
    case 128:
      return run_dq<128>(qf, kf, vf, of, df, lf, dqf, delf, B, S, H, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, dout, dk, dv: (B, S, H, D) f32, contiguous; lse, delta (the dq
// kernel's): (B, H, S) f32.  Writes dk and dv.
extern "C" int smof_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t B,
    int64_t S, int64_t H, int64_t D, int64_t causal, void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *df = (const float*)dout,
              *lf = (const float*)lse, *delf = (const float*)delta;
  float *dkf = (float*)dk, *dvf = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_dkdv<16>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, H, c, st);
    case 32:
      return run_dkdv<32>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, H, c, st);
    case 64:
      return run_dkdv<64>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, H, c, st);
    case 128:
      return run_dkdv<128>(qf, kf, vf, df, lf, delf, dkf, dvf, B, S, H, c,
                           st);
    default: return (int)cudaErrorInvalidValue;
  }
}
