// streamed_matmul: y = x[:, :Ks] @ w_static + x[:, Ks:] @ w_dyn in f32.
//
// Replaces the TPU kernel _kernel (src/repro/kernels/streamed_matmul.py,
// streamed_matmul), the paper's weight fragmentation: a static panel of
// the weight rows pinned on chip and a dynamic remainder streamed in
// blocks.  On the TPU the pinning is what saves HBM traffic.  On the H100
// a whole weight matrix of the executable graphs (at most 4 MB) sits in the
// 50 MB L2, so the split changes no device-memory bytes; the kernel keeps
// the TPU kernel's order of work (the static panel first, then the dynamic
// blocks in order, one f32 accumulator) and nothing else of its layout.
//
// Bound: by operations.  At the main path's shapes (K >= 256, N >= 128)
// it does 2*M*N*K flops on (M*K + K*N + M*N) * 4 bytes, far above the f32
// ridge point of the card, and plain f32 FMAs (no TF32, no tensor cores)
// peak at 67 TFLOP/s.  Design: the classic register-blocked SGEMM.  A block
// of 256 threads owns a 128x128 output tile; per step of 8 along K it
// stages a 128x8 slice of x (transposed) and an 8x128 slice of the weight
// in shared memory, and every thread accumulates an 8x8 sub-tile in
// registers (two 4x4 quadrants 64 apart, so the shared-memory reads of a
// warp hit distinct banks).  64 FMAs per 16 shared-memory loads.  The
// wrapper pads M, N and both K parts to multiples of 128, so the kernel has
// no edge cases.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
static_assert((BM * BK + BK * BN) * sizeof(float) <= 48 * 1024,
              "the staged slices exceed a block's static shared memory");

__global__ void __launch_bounds__(THREADS)
streamed_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_static,
                       const float* __restrict__ w_dyn, float* __restrict__ y,
                       int64_t n, int64_t k, int64_t ks) {
  __shared__ __align__(16) float xs[BK][BM];  // x slice, transposed
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.y * BM, col0 = (int64_t)blockIdx.x * BN;
  // loaders: x slice 128 rows x 8 cols, weight slice 8 rows x 128 cols,
  // one float4 each per thread
  const int xr = tid >> 1, xc = (tid & 1) * 4;
  const int wr = tid >> 5, wc = (tid & 31) * 4;
  // compute: a 16x16 thread grid, each thread rows {ty*4+i, 64+ty*4+i},
  // cols {tx*4+j, 64+tx*4+j}
  const int ty = tid >> 4, tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const float* xrow = x + (row0 + xr) * k + xc;
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const float* w = k0 < ks ? w_static + (k0 + wr) * n
                             : w_dyn + (k0 - ks + wr) * n;
    float4 a = *reinterpret_cast<const float4*>(xrow + k0);
    float4 b = *reinterpret_cast<const float4*>(w + col0 + wc);
    xs[xc + 0][xr] = a.x;
    xs[xc + 1][xr] = a.y;
    xs[xc + 2][xr] = a.z;
    xs[xc + 3][xr] = a.w;
    *reinterpret_cast<float4*>(&ws[wr][wc]) = b;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    float* out = y + r * n + col0;
    *reinterpret_cast<float4*>(out + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// x: (m, k) row-major; w_static: (ks, n); w_dyn: (k - ks, n); y: (m, n).
// m, n, ks and k - ks are multiples of 128 (checked by the wrapper).
extern "C" int smof_streamed_matmul(const void* x, const void* w_static,
                                    const void* w_dyn, void* y, int64_t m,
                                    int64_t n, int64_t k, int64_t ks,
                                    void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((unsigned)(n / BN), (unsigned)(m / BM));
    streamed_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w_static, (const float*)w_dyn,
        (float*)y, n, k, ks);
  }
  return (int)cudaGetLastError();
}
