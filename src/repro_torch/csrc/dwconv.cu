// dwconv: the depthwise temporal conv, y[i, ch] = sum_t w[t, ch] *
// x[i + t - taps/2, ch] with zero 'same' padding; x and y (m, c), w (taps, c).
//
// Replaces the TPU kernel _dwconv_kernel (src/repro/kernels/
// streaming_conv.py, dwconv).  There the input stays un-blocked and each
// grid step reads its overlapping tap windows with pl.ds, the line-buffer
// access pattern.  Here each block owns `tr` consecutive output rows (about
// kValuesPerBlock values) and stages the rows it reads, tr + taps - 1 of
// them with the halo, in shared memory: the rows are contiguous in memory,
// so the stage is one coalesced copy, zeros where a row lies outside
// [0, m).  Bound on the H100 by bytes: 8 bytes move per output and taps
// multiply-adds are done on them; the halo re-reads (taps - 1) / tr rows
// per block, mostly from L2.
//
// Numerics: bit for bit the plain version (kernels/ref.py, dwconv_ref),
// which sums the taps in Python `sum` order, ((0 + w0 x0) + w1 x1) + w2 x2,
// with every product and sum rounded on its own.  nvcc would contract
// a * b + c into an FMA, so the kernel spells each step with __fmul_rn and
// __fadd_rn; the leading 0 + turns -0.0 into +0.0 as Python's sum does.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kValuesPerBlock = 2048;

__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int64_t m, int c, int taps, int tr) {
  extern __shared__ float tile[];  // (tr + taps - 1) rows of c
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int64_t base = (r0 - taps / 2) * c;  // flat index of tile[0]
  const int64_t end = m * c;
  const int n_in = (tr + taps - 1) * c;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int64_t f = base + i;
    tile[i] = (f >= 0 && f < end) ? x[f] : 0.0f;
  }
  __syncthreads();
  const int rows = (int)(m - r0 < tr ? m - r0 : tr);
  float* out = y + r0 * c;
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int r = i / c, ch = i - r * c;
    float s = 0.0f;
    for (int t = 0; t < taps; ++t)
      s = __fadd_rn(s, __fmul_rn(w[t * c + ch], tile[(r + t) * c + ch]));
    out[i] = s;
  }
}

}  // namespace

extern "C" int smof_dwconv(const void* x, const void* w, void* y, int64_t m,
                           int64_t c, int64_t taps, void* stream) {
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  const int tr = (int)(kValuesPerBlock / c > 0 ? kValuesPerBlock / c : 1);
  const size_t smem = (size_t)(tr + taps - 1) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dwconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dwconv_kernel<<<(unsigned)((m + tr - 1) / tr), kThreads, smem,
                  (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                          (float*)y, m, (int)c, (int)taps,
                                          tr);
  return (int)cudaGetLastError();
}
