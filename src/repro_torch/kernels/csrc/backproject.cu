// Parallel-beam backprojection, gather form, a group of slices per block.
//
// Replaces the TPU kernel backproject_pallas (src/repro/kernels/
// backproject/kernel.py, body _bp_kernel).  For S filtered sinograms
// (S, A, D) and angle tables cos/sin (A):
//
//     out[s, y, x] = scale * sum_a lerp(zero-padded sino[s, a], t)
//     t = (x - c) cos(a) + (y - c) sin(a) + centre,  c = (N - 1) / 2
//
// with scale = pi / A.  A ray with t outside (-1, D) adds exactly 0;
// inside, the detector row is zero-padded on both sides, so t in (-1, 0)
// and (D - 1, D) taper linearly to zero (src/repro/kernels/backproject/
// ref.py).
//
// The TPU kernel is a banded hat-function matrix product because the
// MXU wants one; it costs 2*N*N*D*A operations per slice, about a
// thousand times the N*N*A interpolations of the gather at D = 2560.
// Here each output pixel gathers its own two detector bins per angle.
//
// Bound on the card: operations (fp32, outside the tensor cores).  All
// slices share the geometry, so the least work is a position and a
// fraction per (pixel, angle) and a lerp and an add per slice.  What
// holds this kernel is the shared-memory path (two fp32 loads per
// update) together with issue: on the H100, dropping the neighbour
// bin's load cut its time the most of the variants tried, and groups
// of 4 (twice the position work per update) take an eighth longer
// than groups of 8 at 16 slices (PERF.md).
//
// Design.  A block of 256 threads owns a 32 x 32 pixel tile for a group
// of G slices (G = 1, 2, 4 or 8; grid z runs over the groups and the
// last one is masked).  Each thread owns 4 pixels of one tile row, 8
// apart, and G accumulators for each.  For each (pixel, angle) it
// computes the position, its floor and its fraction once and applies
// them to all G slices: per V = min(G, 4) slices, one 4V-byte shared
// load at the bin and one at its neighbour, then two FMAs a slice,
// acc = fma(s1, f, fma(s0, 1 - f, acc)).  A larger group shares the
// position among more slices but computes the masked slices of a
// ragged last group all the same; the C entry point picks the group
// size that, by the per-group times measured on the H100 (PERF.md),
// takes the least time for the scan's slice count.
//
// The position is rounded as the reference rounds it,
// fl(fl(fl(x cos) + fl(y sin)) + centre), by round-to-nearest
// intrinsics, which the compiler does not contract into an FMA; it is
// never stepped from pixel to pixel.  At |t| ~ 2000 one ulp of t moves
// the lerp of a unit-variance row by ~1e-4, and over 1801 angles such
// moves add up.  At the main geometry (D 2560, A 1801, four full image
// rows, tests/test_torch_kernels.py::
// test_backproject_tiled_ref_at_main_geometry) this arithmetic spends
// 1 % of the card check's tolerance (rtol 2e-4, atol 2e-5); with x cos
// contracted into an FMA it spends 81 %, and with t stepped over 8
// pixels 1,591 of 20,480 pixels fall outside it.  What follows the
// position (the lerp and the sum) is fused freely; ref.py's
// backproject_tiled_ref repeats this arithmetic.
//
// Staging.  For a chunk of 16 angles the block stages, per angle and
// slice, the WIN-bin detector window that the tile's rays can reach:
// from the tile centre's bin, HALF bins down and WIN - HALF - 1 up cover
// the half diagonal 15.5 * sqrt(2) = 21.92, the lerp's neighbour and the
// floor, with more than one bin to spare for the rounding of t (the
// wrapper keeps |t| below 2^17).  Bins outside the detector and slices
// past S are staged as zeros, so a ray outside (-1, D) reads two zero
// bins and needs no range check.  The layout is [angle][G / V][bin][V
// slices]: one load returns V slices at one bin, and neighbouring bins
// lie 4V bytes apart; a quarter warp holds 8 neighbouring pixels of a
// row, whose bins lie within 9 of each other, so its loads seldom meet
// in a bank.  The copies are 4-byte cp.async
// (zero-filled where there is no data) into a ring of two stages: the
// next chunk's copies are in flight while this chunk computes, with one
// __syncthreads per chunk.
// Each warp stages whole angles with a lane map fixed at compile time
// (V slices x 32 / V bins per instruction, so the shared stores are
// conflict-free), so the copy loop has no integer division.  Ragged
// tiles, slice groups and angle chunks are masked: any S, A, D, N and
// centre are taken.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                   // pixels per tile side
constexpr int THREADS_X = 8;               // threads across a tile row
constexpr int PIX = TILE / THREADS_X;      // pixels per thread, 8 apart
constexpr int THREADS = THREADS_X * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;                  // angles per stage
constexpr int HALF = 23;                   // window bins below the centre's
constexpr int WIN = 48;                    // window bins per angle and slice
// t0 + (MAGIC - lo - 1) is an integer in [2^23, 2^24): its bits less
// MAGIC_BITS are the window slot of bin t0 - 1, with no conversion
constexpr float MAGIC = 12582912.0f;       // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;

static_assert(CHUNK % WARPS == 0, "each warp stages whole angles");
static_assert(HALF >= 23 && WIN - HALF >= 25,
              "window covers the tile's half diagonal, the neighbour bin "
              "and the floor");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; src_size 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// V slices of one bin, loaded at once
template <int V> struct Bin;
template <> struct Bin<1> { using type = float; };
template <> struct Bin<2> { using type = float2; };
template <> struct Bin<4> { using type = float4; };

// shared memory: [2][CHUNK] angle records (cos, sin, window magic, -),
// then [2][CHUNK][G / V][WIN] windows of V slices a bin
template <int G>
constexpr int smem_bytes() {
    return 2 * CHUNK * (static_cast<int>(sizeof(float4)) +
                        G * WIN * static_cast<int>(sizeof(float)));
}

template <int G>
__global__ void __launch_bounds__(THREADS, 2)
backproject_kernel(const float* __restrict__ sino,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t,
                   float* __restrict__ out, int n_slices, int n_angles,
                   int n_det, int n, float centre, float scale) {
    constexpr int V = G < 4 ? G : 4;       // slices a load
    constexpr int Q = G / V;               // loads a bin
    constexpr int COPY_BINS = 32 / V;      // bins per copy instruction
    using Vec = typename Bin<V>::type;
    extern __shared__ float4 smem[];
    float4* tab = smem;
    Vec* win = reinterpret_cast<Vec*>(smem + 2 * CHUNK);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int x0 = blockIdx.x * TILE + tid % THREADS_X;
    const int y = blockIdx.y * TILE + tid / THREADS_X;
    const int s0 = blockIdx.z * G;
    const float c = (n - 1) * 0.5f;
    const float ys = static_cast<float>(y) - c;
    float xs[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p)
        xs[p] = static_cast<float>(x0 + THREADS_X * p) - c;
    // the tile centre's ray sets each angle's window
    const float xc = blockIdx.x * TILE + (TILE - 1) * 0.5f - c;
    const float yc = blockIdx.y * TILE + (TILE - 1) * 0.5f - c;

    // this lane's copies: slice Vq + lane % V of the group at window
    // bins lane / V + COPY_BINS * u
    const int copy_slice = lane % V;
    const int copy_bin = lane / V;
    const float* rows[Q];
    bool slice_ok[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int s = s0 + V * q + copy_slice;
        slice_ok[q] = s < n_slices;
        rows[q] = sino + static_cast<long long>(slice_ok[q] ? s : 0)
                         * n_angles * n_det;
    }

    auto stage = [&](int a0, int st) {
        const int na = min(CHUNK, n_angles - a0);
#pragma unroll
        for (int i = 0; i < CHUNK / WARPS; ++i) {
            const int k = warp + WARPS * i;
            if (k >= na) break;                      // uniform in the warp
            const int a = a0 + k;
            const float cs = __ldg(cos_t + a);
            const float sn = __ldg(sin_t + a);
            const int lo = static_cast<int>(floorf(xc * cs + yc * sn + centre))
                           - HALF;
            if (lane == 0)
                tab[st * CHUNK + k] = make_float4(
                    cs, sn, MAGIC - static_cast<float>(lo + 1), 0.0f);
            float* dst = reinterpret_cast<float*>(
                win + (st * CHUNK + k) * Q * WIN) + copy_bin * V + copy_slice;
            const long long at = static_cast<long long>(a) * n_det;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
#pragma unroll
                for (int u = 0; u < (WIN + COPY_BINS - 1) / COPY_BINS; ++u) {
                    if (WIN % COPY_BINS != 0 &&
                        copy_bin + COPY_BINS * u >= WIN)
                        break;
                    const int bin = lo + copy_bin + COPY_BINS * u;
                    const bool ok = slice_ok[q] &&
                        static_cast<unsigned>(bin) <
                        static_cast<unsigned>(n_det);
                    cp_async4(dst + (q * WIN + COPY_BINS * u) * V,
                              ok ? rows[q] + at + bin : sino, ok);
                }
            }
        }
    };

    float acc[PIX][G];
#pragma unroll
    for (int p = 0; p < PIX; ++p)
#pragma unroll
        for (int s = 0; s < G; ++s) acc[p][s] = 0.0f;

    const int n_chunks = (n_angles + CHUNK - 1) / CHUNK;
    stage(0, 0);
    cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
        const int st = ch & 1;
        cp_async_wait_all();
        __syncthreads();     // chunk ch has landed; chunk ch - 1 is consumed
        if (ch + 1 < n_chunks) stage((ch + 1) * CHUNK, st ^ 1);
        cp_async_commit();
        const int na = min(CHUNK, n_angles - ch * CHUNK);
        const float4* tb = tab + st * CHUNK;
        const Vec* wb = win + st * CHUNK * Q * WIN;
        for (int k = 0; k < na; ++k) {
            const float4 ang = tb[k];
            const float ysn = __fmul_rn(ys, ang.y);
            const Vec* w = wb + k * Q * WIN;
#pragma unroll
            for (int p = 0; p < PIX; ++p) {
                // the reference's rounding, not contracted, not stepped
                const float t = __fadd_rn(
                    __fadd_rn(__fmul_rn(xs[p], ang.x), ysn), centre);
                const float tp = __fadd_rn(t, 1.0f);
                const float t0 = floorf(tp);
                const float f = __fsub_rn(tp, t0);
                const float f0 = __fsub_rn(1.0f, f);
                // window slot of bin t0 - 1; its neighbour is bin t0
                const Vec* wj = w + (__float_as_int(__fadd_rn(t0, ang.z))
                                     - MAGIC_BITS);
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const Vec b0 = wj[q * WIN];
                    const Vec b1 = wj[q * WIN + 1];
                    const float* g0 = reinterpret_cast<const float*>(&b0);
                    const float* g1 = reinterpret_cast<const float*>(&b1);
                    float* av = acc[p] + V * q;
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        av[v] = __fmaf_rn(g1[v], f,
                                          __fmaf_rn(g0[v], f0, av[v]));
                }
            }
        }
    }

    if (y >= n) return;
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
        const int x = x0 + THREADS_X * p;
        if (x >= n) continue;
#pragma unroll
        for (int s = 0; s < G; ++s) {
            if (s0 + s < n_slices)
                out[(static_cast<long long>(s0 + s) * n + y) * n + x] =
                    __fmul_rn(acc[p][s], scale);
        }
    }
}

template <int G>
int launch(const void* sino, const void* cos_t, const void* sin_t,
           void* out, int n_slices, int n_angles, int n_det, int n,
           float centre, float scale, cudaStream_t stream) {
    const int bytes = smem_bytes<G>();
    cudaError_t err = cudaFuncSetAttribute(
        backproject_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE,
                    (n_slices + G - 1) / G);
    backproject_kernel<G><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(sino), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<float*>(out),
        n_slices, n_angles, n_det, n, centre, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the kernel with groups of `group` slices (1, 2, 4 or 8)
extern "C" int backproject_group(const void* sino, const void* cos_t,
                                 const void* sin_t, void* out, int n_slices,
                                 int n_angles, int n_det, int n,
                                 float centre, float scale, int group,
                                 void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (group) {
    case 1: return launch<1>(sino, cos_t, sin_t, out, n_slices, n_angles,
                             n_det, n, centre, scale, st);
    case 2: return launch<2>(sino, cos_t, sin_t, out, n_slices, n_angles,
                             n_det, n, centre, scale, st);
    case 4: return launch<4>(sino, cos_t, sin_t, out, n_slices, n_angles,
                             n_det, n, centre, scale, st);
    case 8: return launch<8>(sino, cos_t, sin_t, out, n_slices, n_angles,
                             n_det, n, centre, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int backproject(const void* sino, const void* cos_t,
                           const void* sin_t, void* out, int n_slices,
                           int n_angles, int n_det, int n, float centre,
                           float scale, void* stream) {
    // the group size with the least time for n_slices: a launch takes
    // about its number of groups times a group's time, here in 0.1 ms
    // at D 2560, A 1801, N 2560 on the H100 (16 slices, PERF.md §6)
    constexpr int groups[] = {1, 2, 4, 8};
    constexpr int cost[] = {73, 88, 150, 268};
    int best = 0;
    for (int i = 1; i < 4; ++i)
        if ((n_slices + groups[i] - 1) / groups[i] * cost[i] <
            (n_slices + groups[best] - 1) / groups[best] * cost[best])
            best = i;
    return backproject_group(sino, cos_t, sin_t, out, n_slices, n_angles,
                             n_det, n, centre, scale, groups[best], stream);
}
