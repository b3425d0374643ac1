// Error text for the codes the port's C entry points return.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
