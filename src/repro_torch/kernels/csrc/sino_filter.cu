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
// A gang of J scans (a parameter sweep's variants) takes one launch:
// the spectrum holds member j's rows after member j - 1's and filt is
// (J, nf), one filter row per member.  grid.y is the member, so a
// thread knows its filter row without a search; each member's bins are
// scaled by the multiply a launch for that member alone would make,
// bit for bit.  Members of equal row counts (a sweep's variants share
// one chain, so their shapes) pass a null offsets: member j's rows start
// at j * max_rows, computed without a load, which would delay every
// thread's address (one scan is J = 1).  Ragged members pass offsets[j],
// member j's first row.
//
// Design: a streaming pass over the spectrum as one flat array of
// rows * nf bins.  Each thread loads and stores one float4 (two bins, 16
// bytes) with streaming cache hints: the spectrum passes through the
// 50 MB L2 once.  nf is odd, so the two bins of a float4 may lie in
// different rows; each bin takes its own filter value.  Bin indices and
// columns are computed in the index type I: 32-bit below 2^31 bins (the
// shapes of a band or a sweep), 64-bit at or above it (a whole card's
// share of sinograms in one call), so the common shapes keep 32-bit
// arithmetic, whose modulo is the cheaper.  The
// grid covers the array once, one float4 per thread: on the H100 that
// measured faster than a grid of a few blocks per SM striding over it
// with several float4s per thread (PERF.md §6).  A float4 never spans
// two members: a member whose bins start or end at an odd bin leaves
// that bin to a scalar tail, done by the first two threads of the
// member's first block.  Pointers that are not 16-byte aligned take a
// scalar float2 pass.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// bins [first, end) of the member blockIdx.y, and its filter row; span
// is the bins of a member of max_rows rows
template <typename I>
struct Member {
    I first, end;
    const float* filt;
};

template <typename I>
__device__ Member<I> member(const long long* __restrict__ offsets,
                            const float* __restrict__ filt, I span, I nf) {
    const I j = blockIdx.y;
    if (offsets == nullptr) return {j * span, (j + 1) * span, filt + j * nf};
    return {static_cast<I>(offsets[j]) * nf,
            static_cast<I>(offsets[j + 1]) * nf, filt + j * nf};
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
scale_spectrum_vec_kernel(const float4* __restrict__ spec,
                          const float* __restrict__ filt,
                          float4* __restrict__ out,
                          const long long* __restrict__ offsets,
                          I span, I nf) {
    const Member<I> m = member(offsets, filt, span, nf);
    if (blockIdx.x == 0 && threadIdx.x < 2 && m.end > m.first) {
        // the scalar tail: a bin whose float4 the previous or next
        // member shares (the head's thread takes a one-bin member)
        const bool head = threadIdx.x == 0;
        const I i = head ? m.first : m.end - 1;
        const bool odd = head ? (m.first & 1u) != 0
                              : (m.end & 1u) != 0 &&
                                    !(i == m.first && (m.first & 1u));
        if (odd) {
            const float f = __ldg(m.filt + i % nf);
            const float2 x = __ldcs(reinterpret_cast<const float2*>(spec) + i);
            __stcs(reinterpret_cast<float2*>(out) + i,
                   make_float2(x.x * f, x.y * f));
        }
    }
    // float4 f holds bins 2f and 2f + 1, both the member's
    const I f = (m.first + 1) / 2 + static_cast<I>(blockIdx.x) * THREADS +
                threadIdx.x;
    if (f >= m.end / 2) return;
    const I c0 = 2 * f % nf;
    const I c1 = c0 + 1 == nf ? 0 : c0 + 1;
    const float4 x = __ldcs(spec + f);
    const float f0 = __ldg(m.filt + c0);
    const float f1 = __ldg(m.filt + c1);
    __stcs(out + f, make_float4(x.x * f0, x.y * f0, x.z * f1, x.w * f1));
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
scale_spectrum_scalar_kernel(const float2* __restrict__ spec,
                             const float* __restrict__ filt,
                             float2* __restrict__ out,
                             const long long* __restrict__ offsets,
                             I span, I nf) {
    const Member<I> m = member(offsets, filt, span, nf);
    const I i = m.first + static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= m.end) return;
    const float f = __ldg(m.filt + i % nf);
    const float2 x = __ldcs(spec + i);
    __stcs(out + i, make_float2(x.x * f, x.y * f));
}

unsigned blocks(unsigned long long work) {
    return static_cast<unsigned>((work + THREADS - 1) / THREADS);
}

template <typename I>
void launch(const void* spec, const void* filt, void* out,
            const long long* off, unsigned n_members, unsigned long long span,
            I nf, cudaStream_t st) {
    if ((reinterpret_cast<unsigned long long>(spec) |
         reinterpret_cast<unsigned long long>(out)) % 16 == 0) {
        // at least one block per member, for the scalar tail
        const dim3 grid(blocks(span / 2) > 0 ? blocks(span / 2) : 1,
                        n_members);
        scale_spectrum_vec_kernel<I><<<grid, THREADS, 0, st>>>(
            static_cast<const float4*>(spec), static_cast<const float*>(filt),
            static_cast<float4*>(out), off, static_cast<I>(span), nf);
    } else {
        const dim3 grid(blocks(span), n_members);
        scale_spectrum_scalar_kernel<I><<<grid, THREADS, 0, st>>>(
            static_cast<const float2*>(spec), static_cast<const float*>(filt),
            static_cast<float2*>(out), off, static_cast<I>(span), nf);
    }
}

}  // namespace

// spec/out (members' rows, nf) complex64, filt (n_members, nf) float32;
// offsets (n_members + 1) int64 row offsets on the device, or null when
// every member has max_rows rows (one scan: n_members 1); max_rows, the
// most rows a member has, sizes the grid.  Every bin index lies below
// n_members * max_rows * nf: below 2^31 the kernels index in 32 bits,
// else in 64.
extern "C" int scale_spectrum(const void* spec, const void* filt, void* out,
                              const void* offsets, long long n_members,
                              long long max_rows, long long nf,
                              void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* off = static_cast<const long long*>(offsets);
    const unsigned long long span = max_rows * nf;    // bins of a member
    const unsigned j = static_cast<unsigned>(n_members);
    if (span * j < (1ull << 31)) {
        launch<unsigned>(spec, filt, out, off, j, span,
                         static_cast<unsigned>(nf), st);
    } else {
        launch<unsigned long long>(spec, filt, out, off, j, span,
                                   static_cast<unsigned long long>(nf), st);
    }
    return static_cast<int>(cudaGetLastError());
}
