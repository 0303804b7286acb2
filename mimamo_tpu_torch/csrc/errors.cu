// Error text for the codes the kernel entry points return
// (cudaGetLastError() after each launch, or 10000 + the CUresult of a TMA
// descriptor that could not be encoded), for the Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* mimamo_cuda_error_string(int code) {
  if (code >= 10000)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
