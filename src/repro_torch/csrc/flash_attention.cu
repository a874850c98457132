// flash_attention: blockwise softmax attention with the online-softmax
// recurrence, o = softmax(q k^T * D^-1/2 [causal mask]) v over q, o of shape
// (B, S, H, D) and k, v of shape (B, Sk, H, D) in f32, the KV heads already
// repeated to H.  A causal call has Sk == S; a non-causal one may have keys
// of their own length (the encoder-decoder's cross attention: Sk = 1500
// encoder frames against S decoder rows, S = 1 in a decode step).
//
// Replaces the TPU kernel _kernel of flash_attention (src/repro/kernels/
// flash_attention.py), whose grid walks (B H, q blocks, kv blocks) in order
// and carries the running max, sum and (bq, D) accumulator in VMEM scratch
// from one kv step to the next.  Here blocks run in no order, so one block
// owns one (b h, q block) pair and walks the kv tiles itself in a loop;
// kv tiles wholly above the diagonal are never visited (the causal saving),
// the mask is -2^30 as there, and the denominator is clamped at 1e-30.
// Unlike the Pallas wrapper, which asks S % bq == 0, any S is taken: rows
// past S are read as zeros and never written, keys past S are read as
// zeros and get a score of -inf (an exact 0 after the exponential); the kv
// loop runs to Sk and keys past Sk are masked in the tail tile the same way.
// B and H are read in place through the (B, S, H, D) and (B, Sk, H, D)
// strides; no fold copy.
//
// Bound on the H100: causal prefill at S = 512, D = 128 does about 2 S^2 D
// operations per (b, h) on 4 S D values of 4 bytes, 64 operations per byte, so
// it is bound by operations.  Design: both products on the tensor cores
// through the 3xTF32 split of tf32x3.cuh (f32 accuracy; TF32 alone would break
// the 2e-4 parity bound).  Each warp owns 16 query rows and keeps their
// running max, sum and (16, D) o-accumulator in registers in the m16n8
// accumulator layout, so the exp(m_old - m_new) rescale never leaves them.  q
// is staged once per block in shared memory, pre-scaled by D^-1/2 as the
// reference does, and split once: a lane keeps the hi parts of its q fragments
// in registers and the lo parts stay in shared memory.  k and v tiles of BK =
// 32 keys come through a double-buffered cp.async ring, the first one in
// flight while q is staged and each next one while the warps multiply this
// one.  Per tile a warp computes its (16, 32) scores (the even and odd k8
// steps into two accumulators, so that 8 chains of products are in flight, and
// each step's fragments loaded while the last one's products issue), masks
// them where the tile reaches past S or past a row's diagonal, takes the row
// max and sum across the 4 lanes of a row with __shfl_xor_sync, writes the
// probabilities to its own (16, 32) slice of shared memory (the accumulator
// layout is not the A operand's) and multiplies them by v.  The k, probability
// and v operands are split as their fragments are loaded (the split's integer
// instructions cost about as much as the products: a tile's instructions, not
// its products, set the pace).  A warp skips the tiles wholly above its own
// diagonal (they would add exact zeros).  At D = 128 a 4-warp block takes
// 111,616 bytes, so two blocks fit an SM.  Blocks of 4 warps (BQ = 64 query
// rows); the heaviest causal q blocks are issued first.  The exponentials are
// full expf (no fast math).  A cross-attention decode (S = 1 against Sk =
// 1500 keys) runs one block per (b, h) with one active row: it reads K and
// V once, 2 Sk D 4 bytes per (b, h), and is bound by those bytes.
//
// This body is f32 only.  The bf16 instances (flash_attention_bf16,
// flash_attention_lse_bf16) have their own on the bf16 tensor cores
// (flash_attention_bf16.cu).
//
// The training forward (flash_attention_lse) is the same kernel instantiated
// with the compile-time flag LSE: it also writes each row's log-sum-exp of
// the scaled scores, lse = m + log(max(l, 1e-30)) as (B, H, S) f32, which the
// backward kernels (flash_attention_bwd.cu) recompute the probabilities
// from.  The store sits after the tile loop, so the serving instance (LSE
// false) keeps its code, registers and times.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int BK = 32;  // keys a kv tile
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's mask

template <int D>
struct Layout {
  static constexpr int BQ = 16 * WARPS, THREADS = 32 * WARPS;
  // row strides (floats), padded so that a warp's fragment loads hit 32
  // distinct banks: q and k rows read (g, t) -> D + 4, v rows read (t, g)
  // -> D + 8, probabilities (g, t) -> BK + 4
  static constexpr int LDQ = D + 4, LDK = D + 4, LDV = D + 8, LDP = BK + 4;
  static constexpr int Q = BQ * LDQ, K = BK * LDK, V = BK * LDV, P = 16 * LDP;
  static constexpr size_t BYTES =
      (Q + 2 * K + 2 * V + WARPS * P) * sizeof(float);
};

template <int D, bool LSE>
__global__ void __launch_bounds__(32 * WARPS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int64_t S, int64_t Sk,
                       int64_t H, int causal, float scale) {
  using L = Layout<D>;
  constexpr int NF = D / 8;  // k8 steps of q k^T, n fragments of o
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [BQ][LDQ], scaled
  float* kbuf = qs + L::Q;       // 2 x [BK][LDK]
  float* vbuf = kbuf + 2 * L::K;  // 2 x [BK][LDV]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* pw = vbuf + 2 * L::V + warp * L::P;  // this warp's [16][LDP]

  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * L::BQ;
  const int64_t row = H * D;  // stride between positions
  const int64_t base = b * S * row + h * D;    // q and o
  const int64_t kbase = b * Sk * row + h * D;  // k and v

  // a thread copies 16 bytes of each of rows r0 + RS i of a kv tile, at
  // column c4; the first tile is in flight while q is staged
  constexpr int RS = L::THREADS / (D / 4);
  const int r0 = tid / (D / 4), c4 = tid % (D / 4) * 4;
  const float* kg = k + kbase + r0 * row + c4;
  const float* vg = v + kbase + r0 * row + c4;
  auto load_kv = [&](int s, int64_t k0) {
    float* kd = kbuf + s * L::K + r0 * L::LDK + c4;
    float* vd = vbuf + s * L::V + r0 * L::LDV + c4;
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      // a key past Sk is zero-filled from a valid address that is not read
      const bool in = k0 + r0 + RS * i < Sk;
      const int64_t at = (k0 + RS * i) * row;
      tf32x3::cp_async16(kd + RS * i * L::LDK, in ? kg + at : k + kbase, in);
      tf32x3::cp_async16(vd + RS * i * L::LDV, in ? vg + at : v + kbase, in);
    }
  };
  load_kv(0, 0);
  tf32x3::cp_async_commit();

#pragma unroll
  for (int i = 0; i < L::BQ / RS; ++i) {
    const int r = r0 + RS * i;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < S)
      x = *reinterpret_cast<const float4*>(q + base + (q0 + r) * row + c4);
    // q^ = q D^-1/2, as the plain route scales it
    *reinterpret_cast<float4*>(qs + r * L::LDQ + c4) = make_float4(
        x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  // the warp's rows q0 + 16 warp + [0, 16); in the accumulator layout a
  // thread holds rows g (elements 0, 1) and g + 8 (elements 2, 3)
  const int wr = warp * 16;
  const int64_t qw = q0 + wr;
  const bool active = qw < S;
  const int64_t w_end = causal ? (qw + 16 < S ? qw + 16 : S) : Sk;
  const int64_t q_end = q0 + L::BQ < S ? q0 + L::BQ : S;
  const int64_t k_end = causal ? q_end : Sk;  // keys the block's rows need
  const int ntiles = (int)((k_end + BK - 1) / BK);

  // q is split once: each lane keeps the hi parts of its A fragments of
  // q k^T in registers and puts the lo parts back in their places in
  // shared memory (a lane is the only reader of the values it splits)
  __syncthreads();
  uint32_t qh[NF][4];
#pragma unroll
  for (int d = 0; d < NF; ++d) {
    float* pa = qs + (wr + g) * L::LDQ + 8 * d + t;
    const int at[4] = {0, 8 * L::LDQ, 4, 8 * L::LDQ + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo;
      tf32x3::split(pa[at[e]], qh[d][e], lo);
      pa[at[e]] = __uint_as_float(lo);
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = (int64_t)it * BK;
    // tile it has landed and every warp is done with tile it - 1, whose
    // buffer the next load fills while this tile is multiplied
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_kv((it + 1) & 1, k0 + BK);
    tf32x3::cp_async_commit();
    if (!active || k0 >= w_end) continue;
    const float* kt = kbuf + (it & 1) * L::K;
    const float* vt = vbuf + (it & 1) * L::V;

    // scores s = (q D^-1/2) k^T of the warp's 16 rows and the tile's keys,
    // the even and the odd k8 steps into two accumulators (8 independent
    // chains of products, not 4), each step's fragments loaded while the
    // previous step's products are issued
    float s[4][4], s_odd[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_odd[j][e] = 0.0f;
    float ql[4], kr[4][2];
    auto load_qk = [&](int d) {
      const float* pa = qs + (wr + g) * L::LDQ + d + t;
      ql[0] = pa[0];
      ql[1] = pa[8 * L::LDQ];
      ql[2] = pa[4];
      ql[3] = pa[8 * L::LDQ + 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* pb = kt + (j * 8 + g) * L::LDK + d + t;
        kr[j][0] = pb[0];
        kr[j][1] = pb[4];
      }
    };
    load_qk(0);
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      tf32x3::FragA a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a.hi[e] = qh[d / 8][e];
        a.lo[e] = __float_as_uint(ql[e]);
      }
      tf32x3::FragB bk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = tf32x3::split_b(kr[j][0], kr[j][1]);
      if (d + 8 < D) load_qk(d + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32x3::mma_tf32x3(d & 8 ? s_odd[j] : s[j], a, bk[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];

    // mask (only a tile that reaches past Sk or past a row's diagonal),
    // then the online softmax of rows g and g + 8; a row's 32 scores are
    // spread over the 4 lanes 4 g .. 4 g + 3
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > qw)) {
      // keys from `past` on lie past Sk
      const int past = (int)(Sk - k0 < BK ? Sk - k0 : BK);
      const int diag = (int)(qw - k0 < BK ? qw - k0 : BK);  // row 0's last key
#pragma unroll
      for (int j = 0; j < 4; ++j)
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
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // the probabilities through the warp's slice of shared memory, from
    // the accumulator layout to the A operand's
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(pw + g * L::LDP + j * 8 + 2 * t) =
          make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * L::LDP + j * 8 + 2 * t) =
          make_float2(s[j][2], s[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const float* pa = pw + g * L::LDP + kk + t;
      const tf32x3::FragA a =
          tf32x3::split_a(pa[0], pa[8 * L::LDP], pa[4], pa[8 * L::LDP + 4]);
      // the step's v fragments, all loaded before the first product
      float vr[NF][2];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float* pb = vt + (kk + t) * L::LDV + j * 8 + g;
        vr[j][0] = pb[0];
        vr[j][1] = pb[4 * L::LDV];
      }
#pragma unroll
      for (int j = 0; j < NF; ++j)
        tf32x3::mma_tf32x3(acc[j], a, tf32x3::split_b(vr[j][0], vr[j][1]));
    }
    __syncwarp();  // the slice is read before the next tile rewrites it
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = qw + g + 8 * r;
    if (qp >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    if constexpr (LSE) {
      // the 4 lanes of a row hold the same m and l after the shuffles
      if (t == 0) lse[bh * S + qp] = m[r] + logf(fmaxf(l[r], 1e-30f));
    }
    float* out = o + base + qp * row + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      *reinterpret_cast<float2*>(out + j * 8) =
          make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D, bool LSE>
int run_flash(const float* q, const float* k, const float* v, float* o,
              float* lse, int64_t B, int64_t S, int64_t Sk, int64_t H,
              int causal, cudaStream_t st) {
  using L = Layout<D>;
  const cudaError_t err =
      tf32x3::set_shared_memory<flash_attention_kernel<D, LSE>>(
          (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + L::BQ - 1) / L::BQ));
  flash_attention_kernel<D, LSE><<<grid, L::THREADS, L::BYTES, st>>>(
      q, k, v, o, lse, S, Sk, H, causal, elem::head_scale<float>(D));
  return (int)cudaGetLastError();
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, int64_t B, int64_t S, int64_t Sk, int64_t H,
             int64_t D, int64_t causal, void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  // a causal call's keys are its queries' positions; no key, no softmax
  if ((causal && Sk != S) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)o;
  float* lf = (float*)lse;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return run_flash<16, LSE>(qf, kf, vf, of, lf, B, S, Sk, H, c, st);
    case 32:
      return run_flash<32, LSE>(qf, kf, vf, of, lf, B, S, Sk, H, c, st);
    case 64:
      return run_flash<64, LSE>(qf, kf, vf, of, lf, B, S, Sk, H, c, st);
    case 128:
      return run_flash<128, LSE>(qf, kf, vf, of, lf, B, S, Sk, H, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, D) and k, v: (B, Sk, H, D) f32, contiguous; D in {16, 32,
// 64, 128}; causal 0 or 1, and a causal call has Sk == S.
extern "C" int smof_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int64_t B,
                                    int64_t S, int64_t Sk, int64_t H,
                                    int64_t D, int64_t causal,
                                    void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, B, S, Sk, H, D, causal,
                         stream);
}

// The training forward: q, o of shape (B, S, H, D) and k, v of shape (B,
// Sk, H, D) as above, and lse: (B, H, S) f32, each row's log-sum-exp of the
// scaled scores.
extern "C" int smof_flash_attention_lse(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int64_t B, int64_t S, int64_t Sk,
                                        int64_t H, int64_t D, int64_t causal,
                                        void* stream) {
  return dispatch<true>(q, k, v, o, lse, B, S, Sk, H, D, causal, stream);
}

