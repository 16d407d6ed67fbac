// FlashAttention-2 forward (online softmax) with GQA, causal or not.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/kernel.py, body _flash_kernel).  For q (B, Hq, S, D)
// and k, v (B, Hkv, S, D), contiguous, float32 or bfloat16:
//
//     o[b, h, r] = sum_c softmax_c(q[b, h, r] . k[b, h / G, c] / sqrt(D))
//                  * v[b, h / G, c],   G = Hq / Hkv,  causal: c <= r
//
// in the reference's arithmetic order: q is scaled by 1/sqrt(D) in fp32
// before the dot; masked scores are -1e30 (never -inf, so exp(m_prev -
// m_new) never sees inf - inf); m, l and the accumulator are fp32; the
// output is acc / max(l, 1e-30), rounded to the output type to nearest.
//
// Bound on the card: operations.  At the serving shape (B 1, Hq 32,
// S 2048, D 128, causal) the inputs and output are 42 MB against 34 GFLOP.
// This first design does the dots in fp32 FMAs on the CUDA cores, as the
// reference's fp32 dots do, so it cannot pass the fp32 peak (67 TFLOP/s);
// bf16 tensor-core products (mma.sync / wgmma) are the redesign's work.
//
// Design: one block per (q head, 64-row q tile, batch) and 256 threads as
// 16 x 16.  The key sweep is a loop inside the block; m, l and the 64 x D
// accumulator stay in registers across it (each thread owns 4 rows and
// D/16 columns).  The q tile is staged once, scaled and transposed, in
// shared memory; each pass stages a 64-row K tile (transposed) and V
// tile from the kv head that the q head maps to, so grouped heads never
// repeat in memory.  A causal sweep stops at the diagonal tile, and
// blocks are issued longest sweep first.  Ragged lengths are masked:
// rows and columns >= S load as zero, columns >= S score -1e30 and rows
// >= S are not written, so any S is taken.  The row max and sum reduce
// over the 16 threads of a row with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per pass of the sweep
constexpr int TX = 16;            // threads along the columns of a tile
constexpr int TY = 16;            // threads along the rows of a tile
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;       // query rows per thread
constexpr int CN = BK / TX;       // score columns per thread
constexpr int PSTRIDE = BK + 4;   // padded row of the probability tile
constexpr float NEG_INF = -1e30f;
static_assert(RM == 4 && CN == 4, "the score tile is read as float4");

// The probability tile reuses the K tile's space when it fits (D = 128),
// which keeps two blocks on an SM.
template <int D>
__host__ __device__ constexpr bool p_in_k() {
    return D * BK >= BQ * PSTRIDE;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
    return D * BQ + D * BK + BK * D + (p_in_k<D>() ? 0 : BQ * PSTRIDE);
}

__device__ __forceinline__ void load4(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
}

// bfloat16 is the upper half of a float32: widening is a shift, exact.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq,
                 int hkv, int s, bool causal, float scale) {
    constexpr int DV = D / 4;             // 4-wide chunks of a row
    constexpr int DN = D / TX;            // output columns per thread
    constexpr int VEC = D >= 64 ? 4 : 1;  // consecutive columns per read
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* qt = smem;                     // [D][BQ]  q * scale, transposed
    float* kt = qt + D * BQ;              // [D][BK]  k, transposed
    float* vs = kt + D * BK;              // [BK][D]
    float* ps = p_in_k<D>() ? kt : vs + BK * D;   // [BQ][PSTRIDE]

    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int ty = tid / TX;
    const int h = blockIdx.x;
    const int tile = gridDim.y - 1 - blockIdx.y;  // longest sweep first
    const int b = blockIdx.z;
    const int kvh = h / (hq / hkv);
    const int q0 = tile * BQ;
    const long long rows_q = static_cast<long long>(b * hq + h) * s;
    const long long rows_kv = static_cast<long long>(b * hkv + kvh) * s;
    const T* qp = q + rows_q * D;
    const T* kp = k + rows_kv * D;
    const T* vp = v + rows_kv * D;
    T* op = o + rows_q * D;

    // consecutive threads take consecutive rows: conflict-free stores
    // into the transposed tile
    for (int e = tid; e < BQ * DV; e += THREADS) {
        const int r = e % BQ;
        const int c = (e / BQ) * 4;
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (q0 + r < s) load4(qp + static_cast<long long>(q0 + r) * D + c, x);
#pragma unroll
        for (int i = 0; i < 4; ++i) qt[(c + i) * BQ + r] = x[i] * scale;
    }

    float m[RM], l[RM], acc[RM][DN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int n = 0; n < DN; ++n) acc[i][n] = 0.0f;
    }

    const int n_k = causal ? tile + 1 : (s + BK - 1) / BK;
    for (int j = 0; j < n_k; ++j) {
        const int k0 = j * BK;
        __syncthreads();                  // the previous pass is done
        for (int e = tid; e < BK * DV; e += THREADS) {
            const int r = e % BK;
            const int c = (e / BK) * 4;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (k0 + r < s)
                load4(kp + static_cast<long long>(k0 + r) * D + c, x);
#pragma unroll
            for (int i = 0; i < 4; ++i) kt[(c + i) * BK + r] = x[i];
        }
        for (int e = tid; e < BK * DV; e += THREADS) {
            const int r = e / DV;
            const int c = (e % DV) * 4;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (k0 + r < s)
                load4(vp + static_cast<long long>(k0 + r) * D + c, x);
            *reinterpret_cast<float4*>(vs + r * D + c) =
                make_float4(x[0], x[1], x[2], x[3]);
        }
        __syncthreads();

        // scores of rows ty*RM + i against columns tx*CN + n
        float sc[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int n = 0; n < CN; ++n) sc[i][n] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            const float4 a =
                *reinterpret_cast<const float4*>(qt + d * BQ + ty * RM);
            const float4 bb =
                *reinterpret_cast<const float4*>(kt + d * BK + tx * CN);
            const float av[RM] = {a.x, a.y, a.z, a.w};
            const float bv[CN] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int n = 0; n < CN; ++n)
                    sc[i][n] = fmaf(av[i], bv[n], sc[i][n]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int row = q0 + ty * RM + i;
#pragma unroll
            for (int n = 0; n < CN; ++n) {
                const int col = k0 + tx * CN + n;
                if (col >= s || (causal && col > row)) sc[i][n] = NEG_INF;
            }
        }

        // online softmax; the 16 threads of a row are 16 lanes of a warp
        if (p_in_k<D>()) __syncthreads();   // all reads of kt are done
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]),
                             fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
            for (int off = TX / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int n = 0; n < CN; ++n) {
                sc[i][n] = expf(sc[i][n] - m_new);
                sum += sc[i][n];
            }
#pragma unroll
            for (int off = TX / 2; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
#pragma unroll
            for (int n = 0; n < DN; ++n) acc[i][n] *= alpha;
            m[i] = m_new;
            *reinterpret_cast<float4*>(ps + (ty * RM + i) * PSTRIDE +
                                       tx * CN) =
                make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
        }
        __syncthreads();

        // acc += P V over this pass's columns
        for (int c = 0; c < BK; c += 4) {
            float4 pr[RM];
#pragma unroll
            for (int i = 0; i < RM; ++i)
                pr[i] = *reinterpret_cast<const float4*>(
                    ps + (ty * RM + i) * PSTRIDE + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const float* vrow = vs + (c + cc) * D;
#pragma unroll
                for (int g = 0; g < DN / VEC; ++g) {
                    const int d0 = g * TX * VEC + tx * VEC;
                    float w[VEC];
                    if constexpr (VEC == 4) {
                        const float4 t =
                            *reinterpret_cast<const float4*>(vrow + d0);
                        w[0] = t.x;
                        w[1] = t.y;
                        w[2] = t.z;
                        w[3] = t.w;
                    } else {
                        w[0] = vrow[d0];
                    }
#pragma unroll
                    for (int i = 0; i < RM; ++i) {
                        const float p = cc == 0 ? pr[i].x
                                      : cc == 1 ? pr[i].y
                                      : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
                        for (int t = 0; t < VEC; ++t)
                            acc[i][g * VEC + t] =
                                fmaf(p, w[t], acc[i][g * VEC + t]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty * RM + i;
        if (row >= s) continue;
        const float den = fmaxf(l[i], 1e-30f);
        T* orow = op + static_cast<long long>(row) * D;
#pragma unroll
        for (int g = 0; g < DN / VEC; ++g)
#pragma unroll
            for (int t = 0; t < VEC; ++t)
                store(orow + g * TX * VEC + tx * VEC + t,
                      acc[i][g * VEC + t] / den);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int s, int causal, float scale,
                   cudaStream_t stream) {
    const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(hq, (s + BQ - 1) / BQ, b);
    flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s,
        causal != 0, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int hq, int hkv, int s, int d, int causal,
                     float scale, cudaStream_t stream) {
    switch (d) {
        case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, s, causal,
                                      scale, stream);
        case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, s, causal,
                                      scale, stream);
        case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, s, causal,
                                      scale, stream);
        case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, s, causal,
                                        scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int s, int d,
                               int causal, int bf16, float scale,
                               void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, causal,
                                       scale, st)
             : dispatch<float>(q, k, v, o, b, hq, hkv, s, d, causal, scale,
                               st);
    return static_cast<int>(err);
}
