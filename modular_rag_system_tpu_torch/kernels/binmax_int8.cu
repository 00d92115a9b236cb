// binmax_int8: pass 1 of the int8 two-pass top-k on Hopper.
//
// Replaces modular_rag_system_tpu/ops/binmax_topk.py:_binmax_int8_kernel
// (via binmax_int8_call).  For int8 rows E_q (cap, d) with per-row scales
// and int8 queries q (Q, d) with per-query scales it writes
//
//     out[q, b] = max over rows r of bin b of  float(E_q[r] . q) * scale[r] * q_scale[q]
//
// as (Q, nb), nb = cap / bin_width.  The int8 dot product is exact in int32
// (__dp4a), the int32 -> f32 conversion is exact while d*127*127 < 2^24, and
// the two f32 multiplies round in the same order as the TPU kernel, so the
// result is bit-exact against the JAX kernel and the plain PyTorch version.
//
// Bound: the card must read cap*d bytes of rows once and do 2*cap*Q*d int8
// operations; at Q >= ~150 queries the int8 tensor-core rate bounds it, below
// that the row stream does.  This first version is simple: each CTA tiles
// 128 rows x 64 queries in shared memory (64-byte k-steps, padded against
// bank conflicts), each of 256 threads accumulates 8x4 outputs with __dp4a
// on the CUDA cores, then the dequantised tile goes through shared memory
// for the per-bin max.  It runs well below the tensor-core bound; mma/wgmma
// s8 tiles and a cp.async/TMA row pipeline are the way to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;   // rows per CTA
constexpr int BQ = 64;    // queries per CTA
constexpr int BKW = 16;   // int32 words (4 int8 each) per k-step
constexpr int NT = 256;   // threads per CTA: 16 x 16
constexpr int TM = BR / 16;
constexpr int TN = BQ / 16;

__global__ void __launch_bounds__(NT)
binmax_int8_kernel(const int32_t* __restrict__ E32, const int32_t* __restrict__ Q32,
                   const float* __restrict__ scales, const float* __restrict__ q_scale,
                   int cap, int Q, int dw, int bin_width, float* __restrict__ out) {
    __shared__ int32_t As[BR][BKW + 1];
    __shared__ int32_t Bs[BQ][BKW + 1];
    __shared__ float V[BR][BQ + 1];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.x * BR;
    const int q0 = blockIdx.y * BQ;

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int kw0 = 0; kw0 < dw; kw0 += BKW) {
        for (int i = tid; i < BR * BKW; i += NT) {
            const int r = i / BKW, w = i % BKW;
            const int gr = row0 + r, gw = kw0 + w;
            As[r][w] = (gr < cap && gw < dw) ? E32[(size_t)gr * dw + gw] : 0;
        }
        for (int i = tid; i < BQ * BKW; i += NT) {
            const int r = i / BKW, w = i % BKW;
            const int gq = q0 + r, gw = kw0 + w;
            Bs[r][w] = (gq < Q && gw < dw) ? Q32[(size_t)gq * dw + gw] : 0;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < BKW; ++w) {
            int a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][w];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[tx + 16 * j][w];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    // dequantise: float(acc) * row scale, then * query scale (TPU order)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = ty + 16 * i;
        const float rs = (row0 + r < cap) ? scales[row0 + r] : 0.0f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int qq = tx + 16 * j;
            const float qs = (q0 + qq < Q) ? q_scale[q0 + qq] : 0.0f;
            const float v = __int2float_rn(acc[i][j]) * rs;
            V[r][qq] = v * qs;
        }
    }
    __syncthreads();

    // per-bin max; consecutive threads take consecutive bins of one query
    const int nbt = BR / bin_width;
    const int nb = cap / bin_width;
    const int b0 = row0 / bin_width;
    for (int o = tid; o < nbt * BQ; o += NT) {
        const int bl = o % nbt, qq = o / nbt;
        const int gq = q0 + qq, gb = b0 + bl;
        if (gq >= Q || gb >= nb) continue;
        const float* col = &V[bl * bin_width][qq];
        float m = col[0];
        for (int t = 1; t < bin_width; ++t) m = fmaxf(m, col[t * (BQ + 1)]);
        out[(size_t)gq * nb + gb] = m;
    }
}

}  // namespace

// E_q (cap, d) int8, q_i8 (Q, d) int8, scales (cap,) f32, q_scale (Q,) f32,
// out (Q, cap / bin_width) f32.  d % 4 == 0, BR % bin_width == 0 and
// cap % bin_width == 0 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int binmax_int8(const void* E_q, const void* q_i8, const void* scales,
                           const void* q_scale, int cap, int Q, int d, int bin_width,
                           void* out, void* stream) {
    dim3 grid((cap + BR - 1) / BR, (Q + BQ - 1) / BQ);
    binmax_int8_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const int32_t*)E_q, (const int32_t*)q_i8, (const float*)scales,
        (const float*)q_scale, cap, Q, d / 4, bin_width, (float*)out);
    return (int)cudaGetLastError();
}
