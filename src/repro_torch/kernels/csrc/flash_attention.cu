// FlashAttention-2 forward (online softmax) with GQA, causal or not.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/kernel.py, body _flash_kernel).  For q (B, Hq, Sq, D)
// and k, v (B, Hkv, Sk, D), contiguous, float32 or bfloat16:
//
//     o[b, h, r] = sum_c softmax_c(q[b, h, r] . k[b, h / G, c] / sqrt(D))
//                  * v[b, h / G, c],   G = Hq / Hkv,  causal: c <= r
//
// Causal attention takes Sq = Sk (the caller checks); a non-causal one
// (Whisper's cross-attention: decoder tokens against encoder frames)
// sweeps its own Sk keys.  The reference's Pallas kernel sizes both
// grids by q's length, so there the keys past Sq are never read.
//
// Masked scores are -1e30 (never -inf, so exp(m_prev - m_new) never sees
// inf - inf); m, l and the accumulator are fp32; the output is
// acc / max(l, 1e-30), rounded to the output type to nearest.  Both
// kernels below share the sweep: one block per (q head, 64-row q tile,
// batch) loops over 64-row key tiles and keeps m, l and the accumulator
// in registers; GQA reads the kv head its q head maps to, so grouped
// heads never repeat in memory; a causal sweep stops at the diagonal
// tile and blocks are issued longest sweep first; ragged lengths are
// masked (q rows >= Sq and key rows >= Sk load as zero, columns >= Sk
// score -1e30, rows >= Sq are not written), so any Sq and Sk are taken.
//
// Bound on the card: operations.  At the serving shape (B 1, Hq 32,
// S 2048, D 128, causal, bf16) the inputs and output are 42 MB against
// 34 GFLOP, i.e. 0.035 ms at the bf16 tensor-core rate.
//
// bfloat16 (flash_fwd_bf16_kernel, the serving path): both products on
// the tensor cores with mma.sync m16n8k16 (bf16 x bf16 -> fp32).  A block
// is 4 warps; each warp owns 16 q rows and keeps their Q fragments in
// registers for the whole sweep.  S = Q K^T is formed from the raw bf16
// q and k (exact products, fp32 sums) and scaled by the fp32 1/sqrt(D)
// afterwards (the reference scales q first: one fp32 rounding apart).
// The score accumulator's fragment is the A operand of the PV product
// (the FA2 register reuse), so P never goes through shared memory.  P is
// split as p_hi = bf16(p), p_lo = bf16(p - p_hi) and both halves are
// multiplied into the same fp32 accumulator: the reference keeps P in
// fp32, and one bf16 rounding of p (2^-9 of it) moves near-cancelling
// outputs by more than the card check's atol of 1e-3.  l is the fp32
// row sum of the unsplit p; the row max and sum reduce over the 4 lanes
// that share a row.  K and V tiles arrive by cp.async (16 bytes a
// thread, rows past the end zero-filled) into a ring of two stages, so
// the next tile's copy is in flight while the current one computes;
// tiles are stored with their 16-byte chunks XOR-swizzled by row, so
// each 8-row ldmatrix phase touches all 32 banks once.  Shared memory at D 128:
// 16 KB of Q + 2 x 32 KB of K and V = 80 KB, two blocks per SM.
//
// float32 (flash_fwd_f32_kernel, tests and the fp32 parity runs): the
// dots are fp32 FMAs on the CUDA cores, as the reference's fp32 dots
// are; TF32 tensor cores keep about three decimal digits and cannot
// meet the fp32 tolerance.  256 threads as 16 x 16, each owning 4 rows
// and D/16 output columns; q is scaled by 1/sqrt(D) in fp32 before the
// dot, as in the reference; the q tile is staged once, scaled and
// transposed, in shared memory, and each pass stages a K tile
// (transposed) and a V tile; the row max and sum reduce over the 16
// threads of a row with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per pass of the sweep
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- fp32

constexpr int TX = 16;            // threads along the columns of a tile
constexpr int TY = 16;            // threads along the rows of a tile
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;       // query rows per thread
constexpr int CN = BK / TX;       // score columns per thread
constexpr int PSTRIDE = BK + 4;   // padded row of the probability tile
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

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int hq, int hkv, int sq, int sk, bool causal,
                     float scale) {
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
    const long long rows_q = static_cast<long long>(b * hq + h) * sq;
    const long long rows_kv = static_cast<long long>(b * hkv + kvh) * sk;
    const float* qp = q + rows_q * D;
    const float* kp = k + rows_kv * D;
    const float* vp = v + rows_kv * D;
    float* op = o + rows_q * D;

    // consecutive threads take consecutive rows: conflict-free stores
    // into the transposed tile
    for (int e = tid; e < BQ * DV; e += THREADS) {
        const int r = e % BQ;
        const int c = (e / BQ) * 4;
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (q0 + r < sq) load4(qp + static_cast<long long>(q0 + r) * D + c, x);
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

    const int n_k = causal ? tile + 1 : (sk + BK - 1) / BK;
    for (int j = 0; j < n_k; ++j) {
        const int k0 = j * BK;
        __syncthreads();                  // the previous pass is done
        for (int e = tid; e < BK * DV; e += THREADS) {
            const int r = e % BK;
            const int c = (e / BK) * 4;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (k0 + r < sk)
                load4(kp + static_cast<long long>(k0 + r) * D + c, x);
#pragma unroll
            for (int i = 0; i < 4; ++i) kt[(c + i) * BK + r] = x[i];
        }
        for (int e = tid; e < BK * DV; e += THREADS) {
            const int r = e / DV;
            const int c = (e % DV) * 4;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (k0 + r < sk)
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
                if (col >= sk || (causal && col > row)) sc[i][n] = NEG_INF;
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
        if (row >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        float* orow = op + static_cast<long long>(row) * D;
#pragma unroll
        for (int g = 0; g < DN / VEC; ++g)
#pragma unroll
            for (int t = 0; t < VEC; ++t)
                orow[g * TX * VEC + tx * VEC + t] = acc[i][g * VEC + t] / den;
    }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int b, int hq, int hkv, int sq, int sk, int causal,
                       float scale, cudaStream_t stream) {
    const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(hq, (sq + BQ - 1) / BQ, b);
    flash_fwd_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq,
        sk, causal != 0, scale);
    return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int TC_WARPS = BQ / 16;        // each warp owns 16 q rows
constexpr int TC_THREADS = 32 * TC_WARPS;

// Element offset of (row, col) in a [64][D] bf16 tile whose 16-byte
// chunks are XOR-swizzled: the 8 rows that one ldmatrix phase reads at
// one logical chunk land in 8 different 16-byte bank groups.  col is a
// multiple of 8 where an address is formed for ldmatrix or cp.async.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
    constexpr int CPR = D / 8;           // 16-byte chunks per row
    const int chunk = col >> 3;
    int phys;
    if constexpr (CPR >= 8)
        phys = chunk ^ (row & 7);
    else
        phys = chunk ^ ((row / (8 / CPR)) & (CPR - 1));
    return row * D + phys * 8 + (col & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
    return *reinterpret_cast<unsigned*>(&x);
}

// (a, b) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); a in the low half
__device__ __forceinline__ void split(float a, float b, unsigned& hi,
                                      unsigned& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// rows [r0, r0 + 64) of an (n, D) head into a swizzled tile; rows >= n
// are zero-filled (their source address is row 0, never read)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n) {
    constexpr int CPR = D / 8;
    for (int e = threadIdx.x; e < BK * CPR; e += TC_THREADS) {
        const int r = e / CPR;
        const int c = (e % CPR) * 8;
        const bool ok = r0 + r < n;
        cp_async16(dst + swz<D>(r, c),
                   src + static_cast<long long>(ok ? r0 + r : 0) * D + c, ok);
    }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int hq, int hkv,
                      int sq, int sk, bool causal, float scale) {
    static_assert(BQ == BK, "a stage and the q tile share one layout");
    constexpr int KD = D / 16;           // k16 steps of Q K^T
    constexpr int ND = D / 8;            // n8 tiles of the output
    constexpr int NS = BK / 8;           // n8 tiles of the scores
    constexpr int TILE = BK * D;         // elements of one K or V stage
    extern __shared__ float4 smem4[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
    __nv_bfloat16* ks = qs + TILE;       // [2][BK][D], swizzled
    __nv_bfloat16* vs = ks + 2 * TILE;   // [2][BK][D], swizzled

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;             // row of a fragment (and row + 8)
    const int t4 = lane & 3;             // column pair of a fragment
    const int h = blockIdx.x;
    const int tile = gridDim.y - 1 - blockIdx.y;  // longest sweep first
    const int b = blockIdx.z;
    const int kvh = h / (hq / hkv);
    const int q0 = tile * BQ;
    const long long rows_q = static_cast<long long>(b * hq + h) * sq;
    const long long rows_kv = static_cast<long long>(b * hkv + kvh) * sk;
    const __nv_bfloat16* qp = q + rows_q * D;
    const __nv_bfloat16* kp = k + rows_kv * D;
    const __nv_bfloat16* vp = v + rows_kv * D;
    __nv_bfloat16* op = o + rows_q * D;

    // group 0: Q and the first K/V tile; group 1: the second (or none)
    const int n_k = causal ? tile + 1 : (sk + BK - 1) / BK;
    load_tile<D>(qs, qp, q0, sq);
    load_tile<D>(ks, kp, 0, sk);
    load_tile<D>(vs, vp, 0, sk);
    cp_async_commit();
    if (n_k > 1) {
        load_tile<D>(ks + TILE, kp, BK, sk);
        load_tile<D>(vs + TILE, vp, BK, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // this warp's 16 q rows as A fragments, one per k16 step
    unsigned qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], qs + swz<D>(warp * 16 + (lane & 15),
                                        kk * 16 + (lane >> 4) * 8));

    // fragment rows: e = 0, 1 -> row_a; e = 2, 3 -> row_a + 8
    const int row_a = q0 + warp * 16 + g;
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.0f, 0.0f};

    for (int j = 0; j < n_k; ++j) {
        cp_async_wait<1>();              // tile j has landed
        __syncthreads();
        const __nv_bfloat16* kt = ks + (j & 1) * TILE;
        const __nv_bfloat16* vt = vs + (j & 1) * TILE;

        // S = Q K^T: x4 matrices (keys +0/+8) x (d +0/+8) give the B
        // fragments of two n8 tiles of keys
        float sc[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
            for (int np = 0; np < NS / 2; ++np) {
                unsigned bf[4];
                const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
                const int col = kk * 16 + (((lane >> 3) & 1) << 3);
                ldmatrix_x4(bf, kt + swz<D>(key, col));
                mma_bf16(sc[2 * np], qf[kk], bf[0], bf[1]);
                mma_bf16(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
            }
        }

        // scale on the fp32 scores; mask the diagonal and ragged tiles
        const int k0 = j * BK;
        const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > sk;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[n][e] *= scale;
                if (edge) {
                    const int col = k0 + n * 8 + t4 * 2 + (e & 1);
                    const int row = row_a + (e >> 1) * 8;
                    if (col >= sk || (causal && col > row))
                        sc[n][e] = NEG_INF;
                }
            }

        // online softmax over the 4 lanes that share a row
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float mx = sc[0][2 * i];
#pragma unroll
            for (int n = 0; n < NS; ++n)
                mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                sc[n][2 * i] = expf(sc[n][2 * i] - m_new);
                sc[n][2 * i + 1] = expf(sc[n][2 * i + 1] - m_new);
                sum += sc[n][2 * i] + sc[n][2 * i + 1];
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            alpha[i] = expf(m[i] - m_new);
            l[i] = l[i] * alpha[i] + sum;
            m[i] = m_new;
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }

        // acc += (P_hi + P_lo) V: score tiles 2kk, 2kk + 1 are the A
        // fragment of key step kk; x4.trans matrices (keys +0/+8) x
        // (d +0/+8) give the B fragments of two n8 tiles of d
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            unsigned ph[4], pl[4];
            split(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
            split(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
            split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
            split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
            for (int dp = 0; dp < ND / 2; ++dp) {
                unsigned bf[4];
                const int key = kk * 16 + (lane & 7) +
                                (((lane >> 3) & 1) << 3);
                const int col = dp * 16 + ((lane >> 4) << 3);
                ldmatrix_x4_trans(bf, vt + swz<D>(key, col));
                mma_bf16(acc[2 * dp], ph, bf[0], bf[1]);
                mma_bf16(acc[2 * dp], pl, bf[0], bf[1]);
                mma_bf16(acc[2 * dp + 1], ph, bf[2], bf[3]);
                mma_bf16(acc[2 * dp + 1], pl, bf[2], bf[3]);
            }
        }

        __syncthreads();                 // every warp is done with stage
        if (j + 2 < n_k) {
            load_tile<D>(ks + (j & 1) * TILE, kp, (j + 2) * BK, sk);
            load_tile<D>(vs + (j & 1) * TILE, vp, (j + 2) * BK, sk);
        }
        cp_async_commit();               // empty past the end: keeps the
    }                                    // wait count uniform
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row_a + i * 8;
        if (row >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        __nv_bfloat16* orow = op + static_cast<long long>(row) * D + t4 * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * i] / den,
                                      acc[n][2 * i + 1] / den);
    }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int b, int hq, int hkv, int sq, int sk, int causal,
                        float scale, cudaStream_t stream) {
    // the q tile and two stages each of K and V
    const int bytes = 5 * BK * D * static_cast<int>(sizeof(__nv_bfloat16));
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(hq, (sq + BQ - 1) / BQ, b);
    flash_fwd_bf16_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk, causal != 0, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int sk, int causal,
                   int bf16, float scale, cudaStream_t stream) {
    return bf16 ? launch_bf16<D>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                 scale, stream)
                : launch_f32<D>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                scale, stream);
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int sq,
                               int sk, int d, int causal, int bf16,
                               float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (d) {
        case 16: err = launch<16>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                  bf16, scale, st); break;
        case 32: err = launch<32>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                  bf16, scale, st); break;
        case 64: err = launch<64>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                  bf16, scale, st); break;
        case 128: err = launch<128>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                                    bf16, scale, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
