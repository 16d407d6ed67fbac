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
// Design: a streaming pass over the spectrum as one flat array of
// rows * nf bins.  Each thread loads and stores one float4 (two bins, 16
// bytes) with streaming cache hints: the spectrum passes through the
// 50 MB L2 once.  nf is odd, so the two bins of a float4 may lie in
// different rows; each bin takes its own filter value, its column
// computed in 32-bit arithmetic (the wrapper raises at 2^31 bins).  The
// grid covers the array once, one float4 per thread: on the H100 that
// measured faster than a grid of a few blocks per SM striding over it
// with several float4s per thread (PERF.md §6).  An odd bin count
// leaves a scalar tail; pointers that are not 16-byte aligned take a
// scalar float2 pass.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scale_spectrum_vec_kernel(const float4* __restrict__ spec,
                          const float* __restrict__ filt,
                          float4* __restrict__ out, unsigned n4,
                          unsigned nf) {
    // float4 f holds bins 2f and 2f + 1
    const unsigned f = blockIdx.x * THREADS + threadIdx.x;
    if (f >= n4) return;
    const unsigned c0 = 2u * f % nf;
    const unsigned c1 = c0 + 1 == nf ? 0 : c0 + 1;
    const float4 x = __ldcs(spec + f);
    const float f0 = __ldg(filt + c0);
    const float f1 = __ldg(filt + c1);
    __stcs(out + f, make_float4(x.x * f0, x.y * f0, x.z * f1, x.w * f1));
}

__global__ void __launch_bounds__(THREADS)
scale_spectrum_scalar_kernel(const float2* __restrict__ spec,
                             const float* __restrict__ filt,
                             float2* __restrict__ out, unsigned first,
                             unsigned n, unsigned nf) {
    const unsigned i = first + blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float f = __ldg(filt + i % nf);
    const float2 x = __ldcs(spec + i);
    __stcs(out + i, make_float2(x.x * f, x.y * f));
}

unsigned blocks(unsigned work) { return (work + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int scale_spectrum(const void* spec, const void* filt, void* out,
                              long long rows, long long nf, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned n = static_cast<unsigned>(rows * nf);
    const unsigned f = static_cast<unsigned>(nf);
    const auto* fl = static_cast<const float*>(filt);
    unsigned first = 0;             // bins left to the scalar pass
    if ((reinterpret_cast<unsigned long long>(spec) |
         reinterpret_cast<unsigned long long>(out)) % 16 == 0) {
        const unsigned n4 = n / 2;
        if (n4 > 0) {
            scale_spectrum_vec_kernel<<<blocks(n4), THREADS, 0, st>>>(
                static_cast<const float4*>(spec), fl,
                static_cast<float4*>(out), n4, f);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        first = 2 * n4;
    }
    if (first < n) {
        scale_spectrum_scalar_kernel<<<blocks(n - first), THREADS, 0, st>>>(
            static_cast<const float2*>(spec), fl, static_cast<float2*>(out),
            first, n, f);
    }
    return static_cast<int>(cudaGetLastError());
}
