// Fused dark/flat correction + -log linearisation.
//
// Replaces the TPU kernel correct_pallas (src/repro/kernels/correction/
// kernel.py, body _corr_kernel):
//
//     out = -log(clip((raw - dark) / max(flat - dark, eps), eps, hi))
//
// raw is (F, Y, X), dark and flat are (Y, X) float32 and broadcast over
// the frames; out is (F, Y, X) float32.
//
// Bound on the card: bytes.  A handful of operations per pixel against
// 2 bytes read (uint16 raw) + 4 bytes written; dark and flat (Y*X*8
// bytes) stay in the 50 MB L2 across frames.
//
// Design: raw is read in its own type (a template on the input type), so
// a uint16 scan costs 2 B/px and the float32 copy of the raw scan is
// never materialised.  One thread per pixel; grid.y walks the frames so
// the pixel index within a frame (the dark/flat index) needs no 64-bit
// modulo.  Neighbouring threads touch neighbouring addresses.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void correct_kernel(const T* __restrict__ raw,
                               const float* __restrict__ dark,
                               const float* __restrict__ flat,
                               float* __restrict__ out,
                               long long n_frames, long long plane,
                               float eps, float hi) {
    const long long p = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
    if (p >= plane) return;
    const float d = dark[p];
    // max(flat - dark, eps) keeps a dead pixel (flat == dark) finite
    const float denom = fmaxf(flat[p] - d, eps);
    for (long long f = blockIdx.y; f < n_frames; f += gridDim.y) {
        const long long i = f * plane + p;
        const float r = static_cast<float>(raw[i]);
        const float trans = fminf(fmaxf((r - d) / denom, eps), hi);
        out[i] = -logf(trans);
    }
}

template <typename T>
int launch(const void* raw, const void* dark, const void* flat, void* out,
           long long n_frames, long long plane, float eps, float hi,
           void* stream) {
    const int threads = 256;
    const dim3 grid(static_cast<unsigned>((plane + threads - 1) / threads),
                    static_cast<unsigned>(n_frames < 65535 ? n_frames
                                                           : 65535));
    correct_kernel<T><<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(raw), static_cast<const float*>(dark),
        static_cast<const float*>(flat), static_cast<float*>(out),
        n_frames, plane, eps, hi);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int correct_u16(const void* raw, const void* dark,
                           const void* flat, void* out, long long n_frames,
                           long long plane, float eps, float hi,
                           void* stream) {
    return launch<uint16_t>(raw, dark, flat, out, n_frames, plane, eps, hi,
                            stream);
}

extern "C" int correct_f32(const void* raw, const void* dark,
                           const void* flat, void* out, long long n_frames,
                           long long plane, float eps, float hi,
                           void* stream) {
    return launch<float>(raw, dark, flat, out, n_frames, plane, eps, hi,
                         stream);
}
