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
// A gang of J scans takes one launch: raw is the J members' frames one
// after another, member j owning frames [offsets[j], offsets[j + 1]);
// dark and flat are (J, Y, X), member j's at j * Y * X.  grid.z is the
// member, so a block's run of frames never crosses from one member into
// the next: a member's frame count need not be a multiple of RUN, and no
// frame is corrected with a neighbour's dark or flat.  One scan is the
// case J == 1 with null offsets.
//
// Bound on the card: bytes.  A handful of operations per pixel against
// 2 bytes read (uint16 raw) + 4 bytes written; dark and flat are read
// once per run of frames.
//
// Design: raw is read in its own type (a template on the input type), so
// a uint16 scan costs 2 B/px and the float32 copy of the raw scan is
// never materialised.  Each thread owns 8 consecutive pixels of the
// (Y, X) plane and each block walks a run of RUN frames (grid.y =
// ceil(F / RUN), striding past 65535): dark and max(flat - dark, eps)
// for the thread's pixels are loaded once per block into registers, and
// each frame costs one 16-byte load of uint16 raw (two of float32) and
// two 16-byte stores, all with streaming hints: the output (295 MB at
// the main shape) passes through the 50 MB L2 once.  A plane that is
// not a multiple of 8 pixels, or a pointer that is not 16-byte aligned
// (an offset view), takes a scalar kernel of the same shape, one pixel
// per thread.  The division and logf are IEEE, as in the reference.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 4;            // frames per block (beat 8, 16, 32: PERF.md)
constexpr int VEC = 8;            // pixels per thread (vector kernel)

__device__ __forceinline__ float correct1(float r, float d, float den,
                                          float eps, float hi) {
    return -logf(fminf(fmaxf((r - d) / den, eps), hi));
}

__device__ __forceinline__ void load8(const uint16_t* p, float (&r)[VEC]) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        r[2 * i] = static_cast<float>(w[i] & 0xffffu);
        r[2 * i + 1] = static_cast<float>(w[i] >> 16);
    }
}

__device__ __forceinline__ void load8(const float* p, float (&r)[VEC]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void load8_ldg(const float* p, float (&r)[VEC]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
correct_vec_kernel(const T* __restrict__ raw, const float* __restrict__ dark,
                   const float* __restrict__ flat, float* __restrict__ out,
                   const long long* __restrict__ offsets,
                   long long n_frames, long long plane, float eps,
                   float hi) {
    const long long p = (blockIdx.x * static_cast<long long>(THREADS)
                         + threadIdx.x) * VEC;
    if (p >= plane) return;
    const long long lo = offsets ? offsets[blockIdx.z] : 0;
    const long long end = offsets ? offsets[blockIdx.z + 1] : n_frames;
    const long long cal = blockIdx.z * plane;     // this member's dark/flat
    float d[VEC], den[VEC];
    load8_ldg(dark + cal + p, d);
    load8_ldg(flat + cal + p, den);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
        // max(flat - dark, eps) keeps a dead pixel (flat == dark) finite
        den[v] = fmaxf(den[v] - d[v], eps);
    for (long long f0 = lo + blockIdx.y * static_cast<long long>(RUN);
         f0 < end; f0 += static_cast<long long>(gridDim.y) * RUN) {
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            if (f0 + k >= end) break;
            const long long i = (f0 + k) * plane + p;
            float r[VEC];
            load8(raw + i, r);
#pragma unroll
            for (int v = 0; v < VEC; ++v)
                r[v] = correct1(r[v], d[v], den[v], eps, hi);
            float4* o = reinterpret_cast<float4*>(out + i);
            __stcs(o, make_float4(r[0], r[1], r[2], r[3]));
            __stcs(o + 1, make_float4(r[4], r[5], r[6], r[7]));
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
correct_scalar_kernel(const T* __restrict__ raw,
                      const float* __restrict__ dark,
                      const float* __restrict__ flat,
                      float* __restrict__ out,
                      const long long* __restrict__ offsets,
                      long long n_frames, long long plane, float eps,
                      float hi) {
    const long long p = blockIdx.x * static_cast<long long>(THREADS)
                        + threadIdx.x;
    if (p >= plane) return;
    const long long lo = offsets ? offsets[blockIdx.z] : 0;
    const long long end = offsets ? offsets[blockIdx.z + 1] : n_frames;
    const long long cal = blockIdx.z * plane;
    const float d = dark[cal + p];
    const float den = fmaxf(flat[cal + p] - d, eps);
    for (long long f0 = lo + blockIdx.y * static_cast<long long>(RUN);
         f0 < end; f0 += static_cast<long long>(gridDim.y) * RUN) {
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            if (f0 + k >= end) break;
            const long long i = (f0 + k) * plane + p;
            out[i] = correct1(static_cast<float>(raw[i]), d, den, eps, hi);
        }
    }
}

bool aligned16(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

unsigned blocks(long long work) {
    return static_cast<unsigned>((work + THREADS - 1) / THREADS);
}

template <typename T>
int launch(const void* raw, const void* dark, const void* flat, void* out,
           const long long* offsets, long long n_members,
           long long max_frames, long long plane, float eps, float hi,
           void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_members < 1 || n_members > 65535 ||
        (offsets == nullptr && n_members != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long runs = (max_frames + RUN - 1) / RUN;
    const unsigned gy = static_cast<unsigned>(runs < 65535 ? runs : 65535);
    const unsigned gz = static_cast<unsigned>(n_members);
    const auto* r = static_cast<const T*>(raw);
    const auto* d = static_cast<const float*>(dark);
    const auto* f = static_cast<const float*>(flat);
    auto* o = static_cast<float*>(out);
    if (plane % VEC == 0 && aligned16(raw) && aligned16(dark) &&
        aligned16(flat) && aligned16(out)) {
        correct_vec_kernel<T><<<dim3(blocks(plane / VEC), gy, gz), THREADS,
                                0, st>>>(r, d, f, o, offsets, max_frames,
                                         plane, eps, hi);
    } else {
        correct_scalar_kernel<T><<<dim3(blocks(plane), gy, gz), THREADS, 0,
                                   st>>>(r, d, f, o, offsets, max_frames,
                                         plane, eps, hi);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// offsets: null for one member, else n_members + 1 frame offsets on the
// device (offsets[0] == 0); max_frames: the largest member's frame count
// (with null offsets, the frame count), which sizes grid.y.
extern "C" int correct_u16(const void* raw, const void* dark,
                           const void* flat, void* out, const void* offsets,
                           long long n_members, long long max_frames,
                           long long plane, float eps, float hi,
                           void* stream) {
    return launch<uint16_t>(raw, dark, flat, out,
                            static_cast<const long long*>(offsets),
                            n_members, max_frames, plane, eps, hi, stream);
}

extern "C" int correct_f32(const void* raw, const void* dark,
                           const void* flat, void* out, const void* offsets,
                           long long n_members, long long max_frames,
                           long long plane, float eps, float hi,
                           void* stream) {
    return launch<float>(raw, dark, flat, out,
                         static_cast<const long long*>(offsets), n_members,
                         max_frames, plane, eps, hi, stream);
}
