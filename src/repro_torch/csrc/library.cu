// Library-wide helpers of the kernel library's plain C interface.
#include <cuda_runtime.h>

// Message for the cudaError_t a launcher returned, for the wrapper's error.
extern "C" const char* smof_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
