// Error text for the codes the kernel entry points return
// (cudaGetLastError() after each launch), for the Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* mimamo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
