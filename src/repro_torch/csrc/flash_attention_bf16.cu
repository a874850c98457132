// flash_attention_bf16: blockwise softmax attention with the online-softmax
// recurrence on bf16 operands, o = softmax(q^ k^T [causal mask]) v over q, o
// of shape (B, S, H, D) and k, v of shape (B, Sk, H, D) bf16, the KV heads
// already repeated to H; its training instance (flash_attention_lse_bf16)
// also writes each row's log-sum-exp of the scaled scores, lse = m +
// log(max(l, 1e-30)) as (B, H, S) f32, from which the bf16 backward pair
// (flash_attention_bwd_bf16.cu) recomputes P, and o in f32 before its
// rounding (the backward's rowsum(dO o O)
// takes it: from the rounded o it moves by 2^-8 sum |dO o O|, which a
// near-uniform attention's dP - D cancels down to, and its gradients of the
// q and k projections by several times the plain route's bf16 noise).
// They compute what the plain route (models/attention.py,
// chunked_attention) computes from the bf16 operands:
//   q^ = bf16(q bf16(D^-1/2)), s = q^ k^T [causal mask -2^30, keys past Sk
//   -inf], the online softmax in f32 (m, l, the exp(m_old - m_new)
//   rescale), o = (sum P v) / max(l, 1e-30), rounded once to bf16.
// A causal call has Sk == S; a non-causal one may have keys of their own
// length (Sk = 1, 37, 1499 against Sq = 1 or 64 in phase 4 of chip_smoke.py).
//
// Replaces the TPU kernel _kernel of flash_attention (src/repro/kernels/
// flash_attention.py), which is type-generic: its blocks in f32, its output
// in o_ref's type.  It also replaces the bf16 instances of the f32 body
// (flash_attention.cu, once templated on T = bf16), which widened each k and
// v value to f32 as it was staged (a synchronous load and store in place of
// cp.async) and ran both products on the 3xTF32 split, whose lo parts of
// bf16 values are exact zeros: they ran at the f32 instance's speed.
//
// Bound on the H100: causal at (1, 1024, 32, 128) the two products do 2 S
// (S + 1) D operations a (b, h) on 4 S D bf16 values: 8.6e9 operations and
// 33.6 MB, 0.0087 ms at 989 TFLOP/s against 0.0100 ms of bytes; at a
// 512-token prefill the bytes bound it.  This design runs each product on
// the bf16 tensor cores (mma.sync m16n8k16, f32 accumulation; FA-2's forward
// on the helpers of bf16_mma.cuh):
// - s = q^ k^T has two bf16 operands: one native product, every bf16 x bf16
//   product exact in f32.
// - P v multiplies the f32 P by bf16 v.  The plain route keeps P in f32, and
//   one bf16 rounding of P misses phase 4's ulp rule, so P is split in
//   registers into PIECES = 2 bf16 pieces, p1 = bf16(p), p2 = bf16(p - p1),
//   and the product is p2 v + p1 v into one f32 accumulator, the small piece
//   first; tests/test_torch_bf16.py emulates these sums and holds two pieces
//   (and three) to the rule at every bf16 forward shape phase 4 takes.
// So a tile costs 1 + PIECES = 3 bf16 products where 2 are counted: the
// own-products bound is 3/2 of the counted operations at 989 TFLOP/s.  The
// row sum l is taken from the f32 P, so lse means what it meant.
//
// 4 warps (128 threads) a block, 64 query rows, warp w owning rows 16 w ..
// 16 w + 15 and their running max, sum and (16, D) o-accumulator in
// registers in the m16n8 accumulator layout.  q^ is made once per block
// (16-byte loads, scaled and rounded as the plain route rounds it) into
// swizzled shared rows, and each warp keeps its A fragments of q^ k^T in
// registers for the whole walk (D / 4 registers a thread).  k and v tiles of
// BK = 64 keys come through a 3-stage cp.async ring of 16-byte chunks
// XOR-swizzled by row (bf16_mma.cuh's load_tile: a fixed count of copies a
// thread, predicated only in a tile that reaches past Sk), two tiles in
// flight while the warps multiply the third.  Per tile a warp computes its
// 16 x 64 scores over all of D (8 accumulator chains of m16n8k16 products,
// the k fragments through ldmatrix at offsets the lane works out once),
// masks them (only a tile that reaches past Sk or past a row's diagonal),
// takes the row max across the 4 lanes of a row with __shfl_xor_sync,
// rescales its accumulator and hands P straight to the A fragments of P v in
// registers: two adjacent n8 accumulator tiles are the A fragment of a k16
// step over the same keys, so no slice goes through shared memory.  v's B
// fragments come through ldmatrix.trans, each one used by both pieces.  P =
// 2^(s log2(e) - m log2(e)), the exponent one fmaf and the power one
// ex2.approx.ftz (exp2f's instruction, a result below 2^-126 flushed to 0);
// the row sum l is kept a lane at a time and its 4 lanes added after the
// walk.  A warp skips the tiles wholly above its own diagonal (they would
// add exact zeros); the heaviest causal q blocks are issued first.  o is
// multiplied by the reciprocal of max(l, 1e-30), as the f32 body does (the
// plain route divides: at most an f32 ulp apart, within the f32 slack),
// rounded into the warp's own q^ rows and stored in whole 16-byte chunks.
// No atomics and every sum in a fixed order: two launches are bit for bit.
//
// Shared memory at D = 128: q^ 16,384 bytes and the ring 98,304 (3 stages of
// two 64-key tiles), 114,688 a block, so two blocks fit an SM
// (__launch_bounds__(128, 2): up to 255 registers a thread); phase 2 of
// chip_smoke.py prints each instance's shared memory, registers and blocks
// an SM, and fails on a spill.  A cross-attention decode (S = 1 against Sk =
// 1500) runs one block per (b, h) with one active row; it is correct and
// not tuned (no bf16 path decodes across).  Rows past S are read as zeros
// and never written.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <cstdint>

#include "bf16_mma.cuh"
#include "elem.cuh"
#include "tf32x3.cuh"

namespace {

// bf16, WARPS = 4, THREADS, PIECES = 2 (of P), and the helpers
using namespace bf16_mma;

constexpr int ROWS = 16 * WARPS;  // query rows of a block
constexpr int BK = 64;            // keys of a kv tile
constexpr int STAGES = 3;         // tiles in the cp.async ring
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's mask
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2, the instruction exp2f issues, a result below 2^-126
// flushed to 0: a P that small adds nothing an f32 sum of P v can hold
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Layout {
  static constexpr int C = D / 8;    // 16-byte chunks of a row
  static constexpr int KS = D / 16;  // k16 steps of q^ k^T over D
  static constexpr int NT = D / 8;   // n8 tiles of o over D
  static constexpr int QV = ROWS * D;    // bf16 values of q^
  static constexpr int TILEV = BK * D;   // bf16 values of a k or v tile
  // q^ of the rows; ring of STAGES x (k, v)
  static constexpr size_t BYTES = (QV + 2 * STAGES * TILEV) * sizeof(bf16);
};

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, float* __restrict__ ow, int64_t S,
               int64_t Sk, int64_t H, int causal, float scale) {
  using L = Layout<D>;
  constexpr int C = L::C;
  constexpr int NB = BK / 8;  // n8 tiles of a tile's scores
  extern __shared__ uint4 smem_bf16[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // [ROWS][D] q^
  bf16* ring = qs + L::QV;                         // STAGES x (k, v)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the heaviest causal q blocks are issued first
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * ROWS;
  const int64_t row = H * D;  // stride between positions
  const int64_t base = b * S * row + h * D;    // q and o
  const int64_t kbase = b * Sk * row + h * D;  // k and v
  const int64_t q_end = q0 + ROWS < S ? q0 + ROWS : S;
  const int64_t k_end = causal ? q_end : Sk;  // keys the block's rows need
  const int ntiles = (int)((k_end + BK - 1) / BK);

  auto load_kv = [&](int it) {
    bf16* st = ring + 2 * (it % STAGES) * L::TILEV;
    load_tile<D, BK>(st, k + kbase, (int64_t)it * BK, Sk, row);
    load_tile<D, BK>(st + L::TILEV, v + kbase, (int64_t)it * BK, Sk, row);
  };
  load_kv(0);
  tf32x3::cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    tf32x3::cp_async_commit();
  }

  // q^ of the block's rows, rounded once as the plain route rounds it: chunk
  // tid % C of rows tid / C + RS j, as load_tile places them
  {
    constexpr int RS = THREADS / C;
    const int r = tid / C, c = tid % C;
    const bf16* src = q + base + (q0 + r) * row + 8 * c;
    uint4* dst = reinterpret_cast<uint4*>(qs + chunk<C>(r, c));
#pragma unroll
    for (int j = 0; j < ROWS / RS; ++j) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r + RS * j < S)
        u = scaled(*reinterpret_cast<const uint4*>(src + RS * j * row),
                   scale);
      dst[RS * j * C] = u;
    }
  }
  __syncthreads();

  // the warp's rows q0 + 16 warp + [0, 16); in the accumulator layout a
  // thread holds rows g (elements 0, 1) and g + 8 (elements 2, 3)
  const int r0 = 16 * warp;
  const int64_t qw = q0 + r0;
  const bool active = qw < S;
  const int64_t w_end = causal ? (qw + 16 < S ? qw + 16 : S) : Sk;
  uint32_t qa[L::KS][4];  // A fragments of q^, held for the whole walk
#pragma unroll
  for (int ks = 0; ks < L::KS; ++ks) frag_a<C>(qa[ks], qs, r0, ks, lane);

  // the lane's ldmatrix offsets (bytes) into a k tile at k16 step ks and
  // into a v tile at n8 pair dn; 16 rows further on add 32 D (the swizzle
  // repeats every 8 rows from D = 64 up, every 16 / C and 8 / C below)
  uint32_t koff[L::KS], voff[L::NT / 2];
  {
    const int mm = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks)
      koff[ks] = 2 * chunk<C>(8 * (mm >> 1) + (lane & 7), 2 * ks + (mm & 1));
#pragma unroll
    for (int dn = 0; dn < L::NT / 2; ++dn)
      voff[dn] = 2 * chunk<C>(8 * (mm & 1) + (lane & 7), 2 * dn + (mm >> 1));
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = (int64_t)it * BK;
    // tile it has landed and every warp is done with tile it - 1, whose
    // stage the load of tile it + STAGES - 1 fills
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    tf32x3::cp_async_commit();
    // a tile wholly above the warp's diagonal adds exact zeros
    if (!active || k0 >= w_end) continue;
    const bf16* kt = ring + 2 * (it % STAGES) * L::TILEV;
    const uint32_t ka = tf32x3::smem_addr(kt), va = ka + 2 * L::TILEV;

    // s = q^ k^T of the warp's 16 rows and the tile's 64 keys
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks)
#pragma unroll
      for (int nb = 0; nb < NB / 2; ++nb) {
        uint32_t kb[4];
        ldsm(kb, ka + koff[ks] + 32 * nb * D);
        mma(s[2 * nb], qa[ks], kb[0], kb[1]);
        mma(s[2 * nb + 1], qa[ks], kb[2], kb[3]);
      }

    // mask (only a tile that reaches past Sk or past a row's diagonal),
    // then the online softmax of rows g and g + 8; a row's 64 scores are
    // spread over the 4 lanes 4 g .. 4 g + 3
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > qw)) {
      // keys from `past` on lie past Sk
      const int past = (int)(Sk - k0 < BK ? Sk - k0 : BK);
      const int diag = (int)(qw - k0 < BK ? qw - k0 : BK);  // row 0's last key
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1), r = g + 8 * (e >> 1);
          if (c >= past)
            s[j][e] = -CUDART_INF_F;
          else if (causal && c > diag + r)
            s[j][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      ml[r] = -m_new * kLog2e;
    }
    // P = 2^(s log2(e) - m log2(e)), the exponent rounded once; l sums the
    // lane's own P (a row's 4 lanes are added once, after the walk)
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], kLog2e, ml[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += P v over the tile's keys in order, P in its pieces
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      uint32_t a[PIECES][4];
      split(s[2 * kb], s[2 * kb + 1], a);
#pragma unroll
      for (int dn = 0; dn < L::NT / 2; ++dn) {
        uint32_t bv[4];
        ldsm_t(bv, va + voff[dn] + 32 * kb * D);
#pragma unroll
        for (int i = PIECES - 1; i >= 0; --i) {
          mma(acc[2 * dn], a[i], bv[0], bv[1]);
          mma(acc[2 * dn + 1], a[i], bv[2], bv[3]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = qw + g + 8 * r;
    if (qp >= S) continue;
    const float den = fmaxf(l[r], 1e-30f), inv = 1.0f / den;
    if constexpr (LSE) {
      // the 4 lanes of a row hold the same m and l after the shuffles
      if (t == 0) lse[bh * S + qp] = m[r] + logf(den);
      float* out = ow + base + qp * row + 2 * t;
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    // o rounded once, into the warp's own q^ rows (its fragments are held
    // in registers), then out in 16-byte stores of whole chunks
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(qs + chunk<C>(r0 + g + 8 * r, j) + 2 * t) =
          bits(h);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * C; i += 32) {
    const int rr = i / C, c = i % C;
    const int64_t qp = qw + rr;
    if (qp < S)
      *reinterpret_cast<uint4*>(o + base + qp * row + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + chunk<C>(r0 + rr, c));
  }
}

template <int D, bool LSE>
int run_flash(const bf16* q, const bf16* k, const bf16* v, bf16* o,
              float* lse, float* ow, int64_t B, int64_t S, int64_t Sk,
              int64_t H,
              int causal, cudaStream_t st) {
  constexpr size_t bytes = Layout<D>::BYTES;
  const cudaError_t err =
      tf32x3::set_shared_memory<flash_fwd_bf16<D, LSE>>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + ROWS - 1) / ROWS));
  flash_fwd_bf16<D, LSE><<<grid, THREADS, bytes, st>>>(
      q, k, v, o, lse, ow, S, Sk, H, causal, elem::head_scale<bf16>(D));
  return (int)cudaGetLastError();
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, void* ow, int64_t B, int64_t S, int64_t Sk,
             int64_t H, int64_t D, int64_t causal, void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  // a causal call's keys are its queries' positions; no key, no softmax
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
             *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  float *lf = (float*)lse, *wf = (float*)ow;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_flash<16, LSE>(qb, kb, vb, ob, lf, wf, B, S, Sk, H, c,
                                st);
    case 32:
      return run_flash<32, LSE>(qb, kb, vb, ob, lf, wf, B, S, Sk, H, c,
                                st);
    case 64:
      return run_flash<64, LSE>(qb, kb, vb, ob, lf, wf, B, S, Sk, H, c,
                                st);
    case 128:
      return run_flash<128, LSE>(qb, kb, vb, ob, lf, wf, B, S, Sk, H, c,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int occupancy_of(int64_t kernel, int64_t* out) {
  constexpr size_t bytes = Layout<D>::BYTES;
  return kernel == 0 ? occupancy<flash_fwd_bf16<D, false>>(bytes, out)
                     : occupancy<flash_fwd_bf16<D, true>>(bytes, out);
}

}  // namespace

// q, o: (B, S, H, D) and k, v: (B, Sk, H, D) bf16, contiguous; D in {16, 32,
// 64, 128}; causal 0 or 1, and a causal call has Sk == S.
extern "C" int smof_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int64_t B,
                                         int64_t S, int64_t Sk, int64_t H,
                                         int64_t D, int64_t causal,
                                         void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, B, S, Sk, H, D,
                         causal, stream);
}

// The training forward: q, o of shape (B, S, H, D) and k, v of shape (B,
// Sk, H, D) bf16 as above, lse: (B, H, S) f32, each row's log-sum-exp of
// the scaled scores, and ow: (B, S, H, D) f32, o before its rounding.
extern "C" int smof_flash_attention_lse_bf16(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, void* ow, int64_t B,
                                             int64_t S, int64_t Sk, int64_t H,
                                             int64_t D, int64_t causal,
                                             void* stream) {
  return dispatch<true>(q, k, v, o, lse, ow, B, S, Sk, H, D, causal,
                        stream);
}

// out[0..2]: dynamic shared memory bytes, registers a thread and resident
// blocks an SM of the serving (kernel 0) or lse (kernel 1) bf16 instance at
// head width D, on the current device.
extern "C" int smof_flash_attention_bf16_occupancy(int64_t D, int64_t kernel,
                                                   int64_t* out) {
  switch (D) {
    case 16: return occupancy_of<16>(kernel, out);
    case 32: return occupancy_of<32>(kernel, out);
    case 64: return occupancy_of<64>(kernel, out);
    case 128: return occupancy_of<128>(kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
