// dwconv: the depthwise temporal conv, y[i, ch] = sum_t w[t, ch] *
// x[i + t - taps/2, ch] with zero 'same' padding; x and y (m, c), w (taps, c);
// with the fused BFP8 boundary codec.
//
// Replaces the TPU kernels _dwconv_kernel, _dwconv_dec_kernel,
// _dwconv_enc_kernel and _dwconv_dec_enc_kernel (src/repro/kernels/
// streaming_conv.py, dwconv).  There the input stays un-blocked and each
// grid step reads its overlapping tap windows with pl.ds, the line-buffer
// access pattern (the ingress variants hold the whole payload for the same
// reason).  Bound on the H100 by bytes: 8 bytes move per output (5 + 1/32
// with one side encoded, 2 + 1/16 with both) and taps multiply-adds are
// done on them.  So the design reads each input value once, in full-width
// coalesced loads, with enough of them in flight:
//  * a thread owns a quad (4 channels) of a run of `run` output rows
//    (kRun, 16, unless the plan's tile_bm sets it), 8 threads a 32-channel
//    block, neighbouring threads neighbouring quads of a row;
//  * it slides a register window of taps input rows down its run, loading
//    kGroup new rows (kGroup 16-byte loads in flight) for kGroup outputs, so
//    each input row is read once per run plus taps - 1 halo rows (12.5% at
//    taps 3 and run 16).  This replaces a shared-memory tile of about 2048
//    values a block, whose halo was 40% of its reads at c = 384, which
//    staged with a division and a modulo per value, re-read each tap's
//    weight from memory for every output and set its dynamic shared memory
//    size at every launch above 48 KB;
//  * the thread keeps its quad's taps weights in registers;
//  * loads go through Stripe::quad (bfp8.cuh): one 16-byte load of x, or
//    with the decode (kDecode) one char4 of mantissas and one scale for the
//    quad, where c % 4 == 0 and the input is aligned for it, else the
//    quad's channels below c one by one.  The 'same'-padding rows stay
//    zeros and are never decoded, and the payload's padding channels are
//    never read;
//  * with the egress encode (kEncode) the threads of a run cover the
//    payload's nb * 8 quads, so the 8 threads of a 32-channel block form
//    one smof::bfp8_encode_group<8, 4> (channels c <= ch < 32 nb hold
//    zeros, as the spill's padding quantises them); each stores one float4
//    of y, one char4 of mantissas, the group's first thread the exponent.
//  * the window kernel is instantiated for 1 to kMaxTaps taps.  Over more
//    taps (no path launches one; the reference takes any count) the count
//    is a runtime value: dwconv_any_taps_kernel gives a thread one quad of
//    one output row and reads each tap's input and weight quads in turn,
//    so it needs no instance a tap count and no register window whose size
//    the compiler must know.  It re-reads each input row once a tap from
//    the caches, which only matters for a speed no path asks of it.
//
// Numerics: y is bit for bit the plain version's (kernels/ref.py,
// dwconv_ref), which sums the taps in Python `sum` order, ((0 + w0 x0) +
// w1 x1) + w2 x2, with every product and sum rounded on its own, whatever the
// variant or the run.  nvcc would contract a * b + c into an FMA, so the
// kernel spells each step with __fmul_rn and __fadd_rn; the leading 0 +
// turns -0.0 into +0.0 as Python's sum does.
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;      // output rows a thread, bm 0
constexpr int kMaxRun = 64;   // the most rows a bm gives a thread
constexpr int kGroup = 4;     // input rows loaded together
constexpr int kMaxTaps = 7;   // taps the window kernel is built for

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ((0 + w_0 x_0) + w_1 x_1) ..., each step rounded on its own.
__device__ __forceinline__ float tap(float s, float w, float x) {
  return __fadd_rn(s, __fmul_rn(w, x));
}

// Thread (run rn, quad g) of runs * qp threads.  vec: the input's quads
// may be read wide; wvec: w's rows are 16-byte aligned with c % 4 == 0.
template <bool kDecode, bool kEncode, int kTaps>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(smof::Stripe<kDecode> in, const float* __restrict__ w,
              float* __restrict__ y, int8_t* __restrict__ man,
              int8_t* __restrict__ exp, int64_t m, int run, int qp, bool vec,
              bool wvec) {
  constexpr int kPad = kTaps / 2;
  constexpr int kWin = kTaps - 1 + kGroup;
  const int c = (int)in.c;
  const int64_t runs = (m + run - 1) / run;
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // with the encode, whole warps leave together: their groups must shuffle
  if ((kEncode ? gid / 32 * 32 : gid) >= runs * qp) return;
  const bool live = gid < runs * qp;
  const int64_t rn = gid / qp;
  const int g = (int)(gid - rn * qp), ch = g * 4;
  const bool has = live && ch < c;  // the thread holds channels of y
  float4 wt[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    wt[t] = zero4();
    if (has) {
      const float* wp = w + t * c + ch;
      if (wvec) {
        wt[t] = *reinterpret_cast<const float4*>(wp);
      } else {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ch + j < c) v[j] = wp[j];
        wt[t] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  const int64_t r0 = rn * run;  // the run's first output row
  const smof::Stripe<kDecode> s = in.from_row(r0);
  // input row r0 + i of the run, zeros outside [0, m)
  const int lo = r0 < kPad ? (int)-r0 : -kPad;
  const int hi = (int)(m - r0 < run + kWin ? m - r0 : run + kWin);
  const auto load = [=](int i) {
    return has && i >= lo && i < hi ? s.quad(i, ch, vec) : zero4();
  };
  // win[i]: input row r0 + r - kPad + i, for the next output row r0 + r
  float4 win[kWin];
#pragma unroll
  for (int i = 0; i < kTaps - 1; ++i) win[i] = load(i - kPad);
  const int nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  for (int r = 0; r < run; r += kGroup) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      win[kTaps - 1 + i] = load(r - kPad + kTaps - 1 + i);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int64_t row = r0 + r + i;
      const bool out = has && r + i < run && row < m;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        v[0] = tap(v[0], wt[t].x, win[i + t].x);
        v[1] = tap(v[1], wt[t].y, win[i + t].y);
        v[2] = tap(v[2], wt[t].z, win[i + t].z);
        v[3] = tap(v[3], wt[t].w, win[i + t].w);
      }
      float* yp = y + row * c + ch;
      if constexpr (kEncode) {
        if (!has) v[0] = v[1] = v[2] = v[3] = 0.0f;
        int8_t q[4];
        const int e = smof::bfp8_encode_group<8, 4>(v, q);
        // every thread of the run's payload row stores, padding quads too
        if (live && r + i < run && row < m) {
          *reinterpret_cast<char4*>(man + row * nb * smof::kBfp8Block +
                                    ch) = make_char4(q[0], q[1], q[2], q[3]);
          if (g % 8 == 0) exp[row * nb + g / 8] = static_cast<int8_t>(e);
        }
      }
      if (out) {
        if ((c & 3) == 0) {
          *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ch + j < c) yp[j] = v[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTaps - 1; ++i) win[i] = win[i + kGroup];
  }
}

// More than kMaxTaps taps: the tap count is a runtime value, so the
// window cannot live in registers.  Thread (row, quad g) of m * qp threads
// walks the taps of one output row in order, reading each tap's input quad
// (through L1 and L2: each input row is read once for every tap it
// meets) and weight quad, with the window kernel's quads, codec and
// numerics.
template <bool kDecode, bool kEncode>
__global__ void __launch_bounds__(kThreads)
dwconv_any_taps_kernel(smof::Stripe<kDecode> in, const float* __restrict__ w,
                       float* __restrict__ y, int8_t* __restrict__ man,
                       int8_t* __restrict__ exp, int64_t m, int taps, int qp,
                       bool vec, bool wvec) {
  const int c = (int)in.c;
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // with the encode, whole warps leave together: their groups must shuffle
  if ((kEncode ? gid / 32 * 32 : gid) >= m * qp) return;
  const bool live = gid < m * qp;
  const int64_t row = gid / qp;
  const int g = (int)(gid - row * qp), ch = g * 4;
  const bool has = live && ch < c;  // the thread holds channels of y
  const int pad = taps / 2;
  const smof::Stripe<kDecode> s = in.from_row(row);
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (has) {
    for (int t = 0; t < taps; ++t) {
      const int64_t r = row + t - pad;
      const float4 xv = r >= 0 && r < m ? s.quad(t - pad, ch, vec) : zero4();
      const float* wp = w + (int64_t)t * c + ch;
      float4 wv;
      if (wvec) {
        wv = *reinterpret_cast<const float4*>(wp);
      } else {
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ch + j < c) u[j] = wp[j];
        wv = make_float4(u[0], u[1], u[2], u[3]);
      }
      v[0] = tap(v[0], wv.x, xv.x);
      v[1] = tap(v[1], wv.y, xv.y);
      v[2] = tap(v[2], wv.z, xv.z);
      v[3] = tap(v[3], wv.w, xv.w);
    }
  }
  if constexpr (kEncode) {
    const int nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
    int8_t q[4];
    const int e = smof::bfp8_encode_group<8, 4>(v, q);
    if (live) {
      *reinterpret_cast<char4*>(man + row * nb * smof::kBfp8Block + ch) =
          make_char4(q[0], q[1], q[2], q[3]);
      if (g % 8 == 0) exp[row * nb + g / 8] = static_cast<int8_t>(e);
    }
  }
  if (has) {
    float* yp = y + row * c + ch;
    if ((c & 3) == 0) {
      *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < c) yp[j] = v[j];
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kDecode, bool kEncode, int kTaps>
void launch_taps(smof::Stripe<kDecode> in, const float* w, float* y,
                 int8_t* man, int8_t* exp, int64_t m, int run, int qp,
                 bool vec, bool wvec, unsigned blocks, cudaStream_t st) {
  dwconv_kernel<kDecode, kEncode, kTaps><<<blocks, kThreads, 0, st>>>(
      in, w, y, man, exp, m, run, qp, vec, wvec);
}

// A thread's run: bm (the plan's tile_bm) rows where it is > 0, at most
// kMaxRun, else kRun.  The run never changes a result: each output is its
// own tap sum.  Above kMaxTaps taps, dwconv_any_taps_kernel, one row a
// thread.
template <bool kDecode, bool kEncode>
int run_dwconv(smof::Stripe<kDecode> in, const void* w, void* y, void* man,
               void* exp, int64_t m, int64_t taps, int64_t bm,
               void* stream) {
  const int64_t c = in.c;
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  if (taps < 1) return (int)cudaErrorInvalidValue;
  const int run = (int)(bm > 0 ? (bm < kMaxRun ? bm : kMaxRun) : kRun);
  const int64_t nb = (c + smof::kBfp8Block - 1) / smof::kBfp8Block;
  const int qp = (int)(kEncode ? nb * 8 : (c + 3) / 4);
  const int64_t threads = (taps > kMaxTaps ? m : (m + run - 1) / run) * qp;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  const bool vec = c % 4 == 0 && (kDecode ? aligned(in.man, 4)
                                          : aligned(in.x, 16));
  const bool wvec = c % 4 == 0 && aligned(w, 16);
  auto* wf = (const float*)w;
  auto* yf = (float*)y;
  auto* mi = (int8_t*)man;
  auto* ei = (int8_t*)exp;
  const cudaStream_t st = (cudaStream_t)stream;
  if (taps > kMaxTaps) {
    dwconv_any_taps_kernel<kDecode, kEncode><<<blocks, kThreads, 0, st>>>(
        in, wf, yf, mi, ei, m, (int)taps, qp, vec, wvec);
    return (int)cudaGetLastError();
  }
  switch (taps) {
    case 1: launch_taps<kDecode, kEncode, 1>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    case 2: launch_taps<kDecode, kEncode, 2>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    case 3: launch_taps<kDecode, kEncode, 3>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    case 4: launch_taps<kDecode, kEncode, 4>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    case 5: launch_taps<kDecode, kEncode, 5>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    case 6: launch_taps<kDecode, kEncode, 6>(in, wf, yf, mi, ei, m, run, qp,
                                             vec, wvec, blocks, st); break;
    default: launch_taps<kDecode, kEncode, 7>(in, wf, yf, mi, ei, m, run, qp,
                                              vec, wvec, blocks, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (m, c); w: (taps, c), taps >= 1.  With the encode, man: (m,
// nb * 32) and exp: (m, nb), nb = ceil(c / 32); with the decode the input is
// its payload of the same shapes.
extern "C" int smof_dwconv(const void* x, const void* w, void* y, int64_t m,
                           int64_t c, int64_t taps, int64_t bm,
                           void* stream) {
  return run_dwconv<false, false>(smof::f32_stripe(x, c), w, y, nullptr,
                                  nullptr, m, taps, bm, stream);
}

extern "C" int smof_dwconv_encode(const void* x, const void* w, void* y,
                                  void* man, void* exp, int64_t m, int64_t c,
                                  int64_t taps, int64_t bm, void* stream) {
  return run_dwconv<false, true>(smof::f32_stripe(x, c), w, y, man, exp, m,
                                 taps, bm, stream);
}

extern "C" int smof_dwconv_decode(const void* xman, const void* xexp,
                                  const void* w, void* y, int64_t m,
                                  int64_t c, int64_t taps, int64_t bm,
                                  void* stream) {
  return run_dwconv<true, false>(smof::payload_stripe(xman, xexp, c), w, y,
                                 nullptr, nullptr, m, taps, bm, stream);
}

extern "C" int smof_dwconv_decode_encode(const void* xman, const void* xexp,
                                         const void* w, void* y, void* man,
                                         void* exp, int64_t m, int64_t c,
                                         int64_t taps, int64_t bm,
                                         void* stream) {
  return run_dwconv<true, true>(smof::payload_stripe(xman, xexp, c), w, y,
                                man, exp, m, taps, bm, stream);
}
