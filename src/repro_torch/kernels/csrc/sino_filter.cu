// Sinogram-filter spectrum scale: complex64 spectrum x real filter.
//
// Replaces the TPU kernel scale_spectrum_pallas (src/repro/kernels/
// sino_filter/kernel.py, body _scale_kernel).  The TPU kernel splits the
// spectrum into re and im planes only because Mosaic has no complex
// type; here the complex64 spectrum (rows, nf) is scaled in one pass
// over its interleaved (re, im) storage:
//
//     out[r, k] = spec[r, k] * filt[k]
//
// The rfft before and the irfft after stay cuFFT calls (torch.fft), as
// the JAX package leaves them to XLA.
//
// Bound on the card: bytes.  Two multiplies per 16 bytes moved (8 read,
// 8 written); the filter row (nf floats) stays in L1/L2.
//
// Design: one thread per complex bin, read and written as one float2
// (8 bytes per thread, 256 contiguous bytes per warp); grid.y walks the
// rows so the bin index needs no modulo.
#include <cuda_runtime.h>

namespace {

__global__ void scale_spectrum_kernel(const float2* __restrict__ spec,
                                      const float* __restrict__ filt,
                                      float2* __restrict__ out,
                                      long long rows, long long nf) {
    const long long k = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
    if (k >= nf) return;
    const float f = filt[k];
    for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
        const float2 v = spec[r * nf + k];
        out[r * nf + k] = make_float2(v.x * f, v.y * f);
    }
}

}  // namespace

extern "C" int scale_spectrum(const void* spec, const void* filt, void* out,
                              long long rows, long long nf, void* stream) {
    const int threads = 256;
    const dim3 grid(static_cast<unsigned>((nf + threads - 1) / threads),
                    static_cast<unsigned>(rows < 65535 ? rows : 65535));
    scale_spectrum_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(spec), static_cast<const float*>(filt),
        static_cast<float2*>(out), rows, nf);
    return static_cast<int>(cudaGetLastError());
}
