// The decode and decode-encode variants of conv2d (the kernel and its note:
// conv2d.cuh).
#include "conv2d.cuh"

// With the decode, xman: (m, ceil(k / 32) * 32) and xexp: (m, ceil(k / 32))
// in place of x; the rest as in conv2d.cu.
extern "C" int smof_conv2d_decode(const void* xman, const void* xexp,
                                  const void* w, void* y, int64_t m,
                                  int64_t k, int64_t n, int64_t bm,
                                  int64_t bc, void* stream) {
  return run_conv2d<true, false>(nullptr, xman, xexp, w, y, nullptr, nullptr,
                                 m, k, n, bm, bc, stream);
}

extern "C" int smof_conv2d_decode_encode(const void* xman, const void* xexp,
                                         const void* w, void* y, void* man,
                                         void* exp, int64_t m, int64_t k,
                                         int64_t n, int64_t bm, int64_t bc,
                                         void* stream) {
  return run_conv2d<true, true>(nullptr, xman, xexp, w, y, man, exp, m, k, n,
                                bm, bc, stream);
}
