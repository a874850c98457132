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
// A (Ks, BN) static panel pinned in shared memory would not help either:
// the time goes to arithmetic, not to weight bytes.
//
// Bound: by operations.  At the main path's shapes (K >= 256, N >= 128)
// it does 2*M*N*K flops on (M*K + K*N + M*N) * 4 bytes, far above the
// card's ridge point.  Design: the tensor cores through the 3xTF32 split
// of tf32x3.cuh (f32 accuracy at up to 165 TFLOP/s, against 67 for f32
// FMAs).  A block of 8 warps owns a 128x128 output tile; each warp a 64x32
// piece of it, 4x4 m16n8k8 fragments of f32 accumulators in registers.
// The (128, 32) slice of x and the (32, 128) slice of the weight of each
// K step come through a 3-stage cp.async ring in dynamic shared memory, so
// two K steps are in flight while a third is multiplied; rows are padded
// (36 and 136 floats) so that every fragment load of a warp hits 32
// distinct banks.  A warp splits each operand as it loads the fragment.
// 107,520 bytes of ring and at most 128 registers a thread fit two blocks
// on an SM.
//
// Every output element is summed in one order, a function of K alone: the
// K steps in order, within a step its four k8 slices in order, each as
// mma_tf32x3's three products.  No split-K, no atomics, and the same tile
// at every size, so a row's result does not depend on M, on its tile or on
// the grid (the staged, pipelined and served paths are held bit for bit
// against each other).  The wrapper pads M, N and both K parts to
// multiples of 128, so the kernel has no edge cases and no K step
// straddles the static panel and the dynamic blocks.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDA = BK + 4;  // x slice row stride (floats)
constexpr int LDB = BN + 8;  // weight slice row stride
constexpr int STAGE_FLOATS = BM * LDA + BK * LDB;
constexpr size_t SMEM_BYTES = STAGES * STAGE_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 227 * 1024, "the ring exceeds a block's smem");

__global__ void __launch_bounds__(THREADS, 2)
streamed_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_static,
                       const float* __restrict__ w_dyn, float* __restrict__ y,
                       int n, int k, int ks) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int ktiles = k / BK;

  // stage s of the ring: the x slice as[BM][LDA], then the weight slice
  // bs[BK][LDB].  A thread copies 16 bytes of each of 4 rows of x (rows
  // tid / 8 + 32 i) and of the weight (rows tid / 32 + 8 i).
  constexpr int XR = THREADS / (BK / 4), WR = THREADS / (BN / 4);
  const float* xg = x + (row0 + tid / (BK / 4)) * k + tid % (BK / 4) * 4;
  const int wg = tid / (BN / 4) * n + (int)col0 + tid % (BN / 4) * 4;
  const int xs = tid / (BK / 4) * LDA + tid % (BK / 4) * 4;
  const int ws = tid / (BN / 4) * LDB + tid % (BN / 4) * 4;
  auto load_tile = [&](int s, int kt) {
    float* as = smem + s * STAGE_FLOATS;
    float* bs = as + BM * LDA;
    const int k0 = kt * BK;
    const float* w = (k0 < ks ? w_static + (int64_t)k0 * n
                              : w_dyn + (int64_t)(k0 - ks) * n) + wg;
#pragma unroll
    for (int i = 0; i < BM / XR; ++i)
      tf32x3::cp_async16(as + xs + i * XR * LDA, xg + i * XR * k + k0);
#pragma unroll
    for (int i = 0; i < BK / WR; ++i)
      tf32x3::cp_async16(bs + ws + i * WR * LDB, w + i * WR * n);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    tf32x3::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    // tile kt has landed (one younger group may still be in flight), and
    // every warp is done with the stage that the next load overwrites
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_tile(next % STAGES, next);
    tf32x3::cp_async_commit();

    const float* as = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* bs = as + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      tf32x3::FragB b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (kk + t) * LDB + wn + j * 8 + g;
        b[j] = tf32x3::split_b(p[0], p[4 * LDB]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = as + (wm + i * 16 + g) * LDA + kk + t;
        const tf32x3::FragA a =
            tf32x3::split_a(p[0], p[8 * LDA], p[4], p[8 * LDA + 4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32x3::mma_tf32x3(acc[i][j], a, b[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* out = y + r * n + (col0 + wn + j * 8 + 2 * t);
      *reinterpret_cast<float2*>(out) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

// x: (m, k) row-major; w_static: (ks, n); w_dyn: (k - ks, n); y: (m, n).
// m, n, ks and k - ks are multiples of 128 (checked by the wrapper).
extern "C" int smof_streamed_matmul(const void* x, const void* w_static,
                                    const void* w_dyn, void* y, int64_t m,
                                    int64_t n, int64_t k, int64_t ks,
                                    void* stream) {
  // the kernel indexes a weight row, and offsets within a K step, in int
  if (n > INT32_MAX / 128 || k > INT32_MAX / 128)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && n > 0) {
    const cudaError_t err =
        tf32x3::set_shared_memory<streamed_matmul_kernel>((int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(n / BN), (unsigned)(m / BM));
    streamed_matmul_kernel<<<grid, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w_static, (const float*)w_dyn,
        (float*)y, (int)n, (int)k, (int)ks);
  }
  return (int)cudaGetLastError();
}
