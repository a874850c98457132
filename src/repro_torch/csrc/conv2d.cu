// conv2d: the 1x1 channel mix y = x @ w in f32 for conv, matmul and deconv
// vertices whose weight the plan pins whole; x (m, k), w (k, n), y (m, n),
// all three ragged.
//
// Replaces the TPU kernel _conv_kernel (src/repro/kernels/streaming_conv.py,
// conv2d), one full-K jnp.dot per (row block, column block) tile.  The
// shapes it meets on the X3D path are small: the squeeze-excitation
// bottlenecks at m = 1 (k x n from 32 x 48 to 384 x 32), which are bound by
// launch latency, and the classifier head at m = 32768, k = 216, n = 32,
// which at 2 m k n flops on (m k + k n + m n) * 4 bytes is bound by bytes
// (about 7 flops per byte, under the f32 ridge of the card).  Design: a
// register-blocked SGEMM with bounds checks and plain f32 FMAs (no TF32,
// the reference is pure f32).  A block of 256 threads owns a 128 x 32
// output tile, narrow in n because n is 32 on the head; per step of 16
// along k it stages a 128 x 16 slice of x (transposed, padded by 4 floats a
// row against bank conflicts) and a 16 x 32 slice of w in shared memory,
// zeros past every edge, and every thread accumulates a 4 x 4 sub-tile in
// registers, in k order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 32, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int64_t m, int64_t k, int64_t n) {
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty..4ty+3, cols 4tx..4tx+3
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const int xk = tid & (BK - 1);
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {
      const int r = (tid >> 4) + j * (THREADS / BK);
      const int64_t gr = row0 + r, gk = k0 + xk;
      xs[xk][r] = (gr < m && gk < k) ? x[gr * k + gk] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int kk = (tid >> 5) + j * (THREADS / BN);
      const int64_t gk = k0 + kk, gc = col0 + (tid & (BN - 1));
      ws[kk][tid & (BN - 1)] = (gk < k && gc < n) ? w[gk * n + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t cc = col0 + tx * 4 + j;
      if (cc < n) y[r * n + cc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int smof_conv2d(const void* x, const void* w, void* y, int64_t m,
                           int64_t k, int64_t n, void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
    conv2d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, m, k, n);
  }
  return (int)cudaGetLastError();
}
