// Parallel-beam backprojection, gather form, all slices in one launch.
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
// Bound on the card: operations (fp32, outside the tensor cores).  The
// sinograms and the image are read and written once; every (pixel,
// angle) pair costs a position, a floor, a lerp and an add.
//
// Design: a block owns a 16 x 16 pixel tile of one slice (grid z = the
// slice).  For each chunk of 64 angles it stages cos/sin and, per angle,
// the 32-bin detector window that the tile's rays can reach (at most
// 15 * sqrt(2) + 2 bins wide around the tile centre's t) in shared
// memory, zero outside the detector; the angle loop accumulates in a
// register.  Ragged tile edges and angle counts are masked, so any
// N, A and D are taken.  The arithmetic uses round-to-nearest intrinsics
// in the reference's order, so no contraction into FMAs changes the
// rounding against the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;          // pixels per tile side
constexpr int CHUNK = 64;         // angles staged per pass
constexpr int WIN = 32;           // detector bins staged per angle
constexpr int HALF = WIN / 2;

__global__ void backproject_kernel(const float* __restrict__ sino,
                                   const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t,
                                   float* __restrict__ out,
                                   int n_angles, int n_det, int n,
                                   float centre, float scale) {
    __shared__ float s_cos[CHUNK];
    __shared__ float s_sin[CHUNK];
    __shared__ int s_lo[CHUNK];
    __shared__ float s_win[CHUNK][WIN];

    const int tid = threadIdx.y * TILE + threadIdx.x;
    const int x = blockIdx.x * TILE + threadIdx.x;
    const int y = blockIdx.y * TILE + threadIdx.y;
    const bool live = x < n && y < n;
    const float c = (n - 1) * 0.5f;
    const float xs = static_cast<float>(x) - c;
    const float ys = static_cast<float>(y) - c;
    // centre of this tile, for the window each angle stages
    const float xc = blockIdx.x * TILE + (TILE - 1) * 0.5f - c;
    const float yc = blockIdx.y * TILE + (TILE - 1) * 0.5f - c;
    const float* rows = sino + static_cast<long long>(blockIdx.z)
                               * n_angles * n_det;
    const float det = static_cast<float>(n_det);

    float acc = 0.0f;
    for (int a0 = 0; a0 < n_angles; a0 += CHUNK) {
        const int na = min(CHUNK, n_angles - a0);
        __syncthreads();                 // previous chunk fully consumed
        for (int k = tid; k < na; k += TILE * TILE) {
            const float cs = cos_t[a0 + k];
            const float sn = sin_t[a0 + k];
            s_cos[k] = cs;
            s_sin[k] = sn;
            s_lo[k] = static_cast<int>(floorf(xc * cs + yc * sn + centre))
                      - HALF;
        }
        __syncthreads();
        for (int e = tid; e < na * WIN; e += TILE * TILE) {
            const int k = e / WIN;
            const int j = e - k * WIN;
            const int bin = s_lo[k] + j;
            s_win[k][j] = (bin >= 0 && bin < n_det)
                ? rows[static_cast<long long>(a0 + k) * n_det + bin] : 0.0f;
        }
        __syncthreads();
        if (live) {
            for (int k = 0; k < na; ++k) {
                const float t = __fadd_rn(
                    __fadd_rn(__fmul_rn(xs, s_cos[k]),
                              __fmul_rn(ys, s_sin[k])), centre);
                if (t > -1.0f && t < det) {
                    const float tp = __fadd_rn(t, 1.0f);
                    const float t0 = floorf(tp);
                    const float frac = __fsub_rn(tp, t0);
                    // window slot of sino[floor(tp) - 1]; its neighbour
                    // is sino[floor(tp)]
                    const int j = static_cast<int>(t0) - 1 - s_lo[k];
                    const float v = __fadd_rn(
                        __fmul_rn(s_win[k][j], __fsub_rn(1.0f, frac)),
                        __fmul_rn(s_win[k][j + 1], frac));
                    acc = __fadd_rn(acc, v);
                }
            }
        }
    }
    if (live) {
        out[(static_cast<long long>(blockIdx.z) * n + y) * n + x] =
            __fmul_rn(acc, scale);
    }
}

}  // namespace

extern "C" int backproject(const void* sino, const void* cos_t,
                           const void* sin_t, void* out, int n_slices,
                           int n_angles, int n_det, int n, float centre,
                           float scale, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE, n_slices);
    backproject_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sino), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<float*>(out),
        n_angles, n_det, n, centre, scale);
    return static_cast<int>(cudaGetLastError());
}
