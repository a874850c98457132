// The plain and encode variants of conv2d (the kernel and its note:
// conv2d.cuh).
#include "conv2d.cuh"

// x: (m, k); w: (k, n); y: (m, n).  With the encode, man: (m, ceil(n / 32)
// * 32) and exp: (m, ceil(n / 32)).  bm, bc: the tiles.
extern "C" int smof_conv2d(const void* x, const void* w, void* y, int64_t m,
                           int64_t k, int64_t n, int64_t bm, int64_t bc,
                           void* stream) {
  return run_conv2d<false, false>(x, nullptr, nullptr, w, y, nullptr, nullptr,
                                  m, k, n, bm, bc, stream);
}

extern "C" int smof_conv2d_encode(const void* x, const void* w, void* y,
                                  void* man, void* exp, int64_t m, int64_t k,
                                  int64_t n, int64_t bm, int64_t bc,
                                  void* stream) {
  return run_conv2d<false, true>(x, nullptr, nullptr, w, y, man, exp, m, k,
                                 n, bm, bc, stream);
}
