// flash_attention: blockwise softmax attention with the online-softmax
// recurrence, o = softmax(q k^T * D^-1/2 [causal mask]) v over q, k, v, o of
// shape (B, S, H, D) in f32, the KV heads already repeated to H.
//
// Replaces the TPU kernel _kernel of flash_attention (src/repro/kernels/
// flash_attention.py), whose grid walks (B H, q blocks, kv blocks) in order
// and carries the running max, sum and (bq, D) accumulator in VMEM scratch
// from one kv step to the next.  Here blocks run in no order, so one block
// owns one (q block, b h) pair and walks the kv tiles itself in a loop,
// with the running max, sum and accumulator in registers; kv tiles wholly
// above the diagonal are never visited (the causal saving), the mask is
// -2^30 as there, and the denominator is clamped at 1e-30.  Unlike the
// Pallas wrapper, which asks S % bq == 0, any S is taken: rows past S are
// read as zeros and never written, columns past S get a score of -inf (an
// exact 0 after the exponential).  B and H are read in place through the
// (B, S, H, D) strides; no fold copy.
//
// Bound on the H100: causal prefill at S = 512, D = 128 does about 2 S^2 D
// f32 operations per (b, h) on 4 S D values of 4 bytes, 64 operations per
// byte, above the f32 ridge (20 operations per byte), so it is bound by
// operations.  Design: plain f32 FMAs (no tensor cores; TF32 stays off for
// parity with the reference's pure f32).  A block of 256 threads (16 x 16)
// takes BQ = 64 query rows; per kv tile of BK = 64 keys it stages k (as
// k^T, so that a thread reads four keys with one float4) and v in shared
// memory, beside q^T (staged once, pre-scaled by D^-1/2 as the reference
// does).  Thread (ty, tx) computes the 4 x 4 scores of rows 4 ty .. 4 ty + 3
// and keys 4 tx .. 4 tx + 3 as a sum over d in order; the 16 threads of a
// row are 16 neighbouring lanes, which take the row's max and sum with
// __shfl_xor_sync.  The probabilities go to shared memory (transposed), and
// the same thread then accumulates its 4 rows of o over columns tx + 16 j,
// j < D / 16, in key order.  The thread owns the same rows in both
// products, so the rescale by exp(m_old - m_new) stays in its registers.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's mask

template <int D>
struct Smem {
  float qt[D][BQ + 4];  // q^T, scaled
  float kt[D][BK + 4];  // k^T of the kv tile
  float v[BK][D];       // v of the kv tile
  float pt[BK][BQ + 4];  // probabilities, transposed
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int64_t S, int64_t H, int causal, float scale) {
  constexpr int DC = D / 16;  // o columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int64_t row = H * D;  // stride between positions
  const int64_t base = b * S * row + h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    sm.qt[d][r] = q0 + r < S ? q[base + (q0 + r) * row + d] * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  // kv tiles up to the last one that holds a key at or below the block's
  // last row (causal), or to the end
  const int64_t q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
  const int64_t k_end = causal ? q_last + 1 : S;
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done (and q^T staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const bool in = k0 + c < S;
      const int64_t at = base + (k0 + c) * row + d;
      sm.kt[d][c] = in ? k[at] : 0.0f;
      sm.v[c][d] = in ? v[at] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qt[d][ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&sm.kt[d][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx * 4 + j;
        if (kp >= S)
          s[i][j] = -CUDART_INF_F;
        else if (causal && qp < kp)
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 16 threads are lanes 16 (ty % 2) + tx
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.pt[tx * 4 + j][ty * 4 + i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&sm.pt[c][ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sm.v[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty * 4 + i;
    if (qp >= S) break;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[base + qp * row + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int D>
int run_flash(const float* q, const float* k, const float* v, float* o,
              int64_t B, int64_t S, int64_t H, int causal,
              cudaStream_t st) {
  const size_t smem = sizeof(Smem<D>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H));
  // D^-1/2 rounded once to f32, as the reference's q * D ** -0.5
  const float scale = (float)(1.0 / std::sqrt((double)D));
  flash_attention_kernel<D><<<grid, THREADS, smem, st>>>(q, k, v, o, S, H,
                                                         causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) f32, contiguous; D in {16, 32, 64, 128};
// causal 0 or 1.
extern "C" int smof_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int64_t B,
                                    int64_t S, int64_t H, int64_t D,
                                    int64_t causal, void* stream) {
  if (B * S * H <= 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16: return run_flash<16>(qf, kf, vf, of, B, S, H, c, st);
    case 32: return run_flash<32>(qf, kf, vf, of, B, S, H, c, st);
    case 64: return run_flash<64>(qf, kf, vf, of, B, S, H, c, st);
    case 128: return run_flash<128>(qf, kf, vf, of, B, S, H, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
