// Shared entry points of the tomography kernel library.
//
// Every kernel of the library is exported with a plain C interface and
// returns cudaGetLastError() after its launch; the Python wrapper raises
// when that is not cudaSuccess and reads the text through this function.
#include <cuda_runtime.h>

extern "C" const char* tomo_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
