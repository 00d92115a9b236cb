// mea_attention: memory-efficient self-attention of the encoder on Hopper.
//
// Replaces modular_rag_system_tpu/ops/flash_attention.py:_mea_kernel (via
// mea_attention).  For q, k, v (B, L, H, dh) in the model dtype (bf16 or
// f32) and a key-padding mask pad (B, L) (1 = live) it computes, per batch
// row and head,
//
//     out = softmax(q k^T / sqrt(dh), masked keys at -1e9) v
//
// with the TPU kernel's rounding: the scores are f32 sums of the operands'
// products times the scale, the softmax runs in f32, a masked key scores a
// finite -1e9 (so a row whose keys are all padding softmaxes uniformly and
// stays finite), the probabilities exp(s - m) are rounded to the model
// dtype before they multiply v, that product accumulates in f32, and the
// row sum of the unrounded exponentials, floored at 1e-30, divides at the
// end.  The tensors are read as laid out: no padding of dh, no transposed
// copy of k, and no (L, L) tensor in global memory.
//
// Bound: q, k, v read and out written once (4 B L H dh values) against
// 4 B H L^2 dh operations: by operations from L of a few hundred on.
// Design: one CTA per (batch row x head, block of 64 query rows); k and v
// stream through shared memory in tiles of 64 keys, twice: the first sweep
// keeps each query row's running maximum and sum, the second recomputes the
// scores, forms exp(s - m) with the final maximum, rounds it and multiplies
// it into v.  Products run on the CUDA cores in f32 (a 4 x 4 register tile
// of scores per thread), which keeps the f32 model exact; tensor-core
// products (mma / wgmma) for the bf16 model are left to a later version.

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per tile
constexpr int LDS = BK + 1;
constexpr float MASKED = -1e9f;

template <bool BF16>
__device__ __forceinline__ float load_val(const void* p, size_t idx) {
    if (BF16) return __uint_as_float((uint32_t)((const uint16_t*)p)[idx] << 16);
    return ((const float*)p)[idx];
}

// a tile of 64 keys (and their values) as f32 in shared memory; keys at or
// past L are zero rows marked -1, padded keys are marked 0, live keys 1
template <bool BF16>
__device__ __forceinline__ void load_tile(const void* k, const void* v, const float* pad_row,
                                          size_t base, size_t rstride, int k0, int L, int dh,
                                          int ldq, float* Ks, float* Vs, float* live,
                                          bool with_v) {
    for (int idx = threadIdx.x; idx < BK * dh; idx += NT) {
        const int r = idx / dh, c = idx % dh, j = k0 + r;
        const size_t g = base + (size_t)j * rstride + c;
        Ks[r * ldq + c] = j < L ? load_val<BF16>(k, g) : 0.0f;
        if (with_v) Vs[r * dh + c] = j < L ? load_val<BF16>(v, g) : 0.0f;
    }
    for (int r = threadIdx.x; r < BK; r += NT) {
        const int j = k0 + r;
        live[r] = j < L ? (pad_row[j] > 0.5f ? 1.0f : 0.0f) : -1.0f;
    }
}

// Ss[r][c] = scale * q_r . k_c for the 64 x 64 tile, masked keys at -1e9,
// keys past L at -inf; each thread a 4 x 4 register tile
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks, const float* live,
                                           int dh, int ldq, float scale, float* Ss) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int dd = 0; dd < dh; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float lv = live[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float s = acc[i][j] * scale;
            Ss[(ty + 16 * i) * LDS + c] = lv > 0.5f ? s : (lv < -0.5f ? -INFINITY : MASKED);
        }
    }
}

// DHP: dh rounded up to 32, 64 or 128 (the output accumulators per thread)
template <bool BF16, int DHP>
__global__ void __launch_bounds__(NT)
mea_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const float* __restrict__ pad,
                     void* __restrict__ out, int L, int H, int dh, float scale) {
    extern __shared__ float sm[];
    const int ldq = dh + 1;
    float* Qs = sm;               // BQ x ldq
    float* Ks = Qs + BQ * ldq;    // BK x ldq
    float* Vs = Ks + BK * ldq;    // BK x dh
    float* Ss = Vs + BK * dh;     // BQ x LDS
    float* live = Ss + BQ * LDS;  // BK

    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const size_t rstride = (size_t)H * dh;             // values between positions
    const size_t base = ((size_t)b * L * H + h) * dh;  // value (b, 0, h, 0)
    const float* pad_row = pad + (size_t)b * L;

    for (int idx = threadIdx.x; idx < BQ * dh; idx += NT) {
        const int r = idx / dh, c = idx % dh, l = q0 + r;
        Qs[r * ldq + c] = l < L ? load_val<BF16>(q, base + (size_t)l * rstride + c) : 0.0f;
    }

    // four threads own one query row: its statistics and its output
    const int srow = threadIdx.x / 4, spart = threadIdx.x % 4;
    float m_run = -INFINITY, l_run = 0.0f;

    // sweep 1: the row maxima and the sums of exp(s - m)
    for (int k0 = 0; k0 < L; k0 += BK) {
        __syncthreads();  // the previous tile is done with
        load_tile<BF16>(k, v, pad_row, base, rstride, k0, L, dh, ldq, Ks, Vs, live, false);
        __syncthreads();
        score_tile(Qs, Ks, live, dh, ldq, scale, Ss);
        __syncthreads();
        float tmax = -INFINITY;
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) tmax = fmaxf(tmax, Ss[srow * LDS + spart + 4 * cc]);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        // a tile holds a key below L, so the new maximum is finite
        const float m_new = fmaxf(m_run, tmax);
        float sum = 0.0f;
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) sum += expf(Ss[srow * LDS + spart + 4 * cc] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
    }

    // sweep 2: exp(s - m) rounded to the model dtype, times v, summed in f32
    float o[DHP / 4];
#pragma unroll
    for (int jj = 0; jj < DHP / 4; ++jj) o[jj] = 0.0f;
    for (int k0 = 0; k0 < L; k0 += BK) {
        __syncthreads();
        load_tile<BF16>(k, v, pad_row, base, rstride, k0, L, dh, ldq, Ks, Vs, live, true);
        __syncthreads();
        score_tile(Qs, Ks, live, dh, ldq, scale, Ss);
        __syncthreads();
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) {
            float* s = Ss + srow * LDS + spart + 4 * cc;
            const float p = expf(*s - m_run);
            *s = BF16 ? topk::round_bf16(p) : p;
        }
        __syncwarp();  // a row's four threads are in one warp
        for (int kk = 0; kk < BK; ++kk) {
            const float p = Ss[srow * LDS + kk];
#pragma unroll
            for (int jj = 0; jj < DHP / 4; ++jj) {
                const int c = spart + 4 * jj;
                if (c < dh) o[jj] += p * Vs[kk * dh + c];
            }
        }
    }

    const int l = q0 + srow;
    if (l < L) {
        const float denom = fmaxf(l_run, 1e-30f);
        const size_t g = base + (size_t)l * rstride;
#pragma unroll
        for (int jj = 0; jj < DHP / 4; ++jj) {
            const int c = spart + 4 * jj;
            if (c >= dh) continue;
            const float val = o[jj] / denom;
            if (BF16)
                ((uint16_t*)out)[g + c] =
                    (uint16_t)(__float_as_uint(topk::round_bf16(val)) >> 16);
            else
                ((float*)out)[g + c] = val;
        }
    }
}

template <bool BF16, int DHP>
int launch(const void* q, const void* k, const void* v, const void* pad, void* out, int B,
           int L, int H, int dh, float scale, cudaStream_t stream) {
    const size_t smem =
        ((size_t)(BQ + BK) * (dh + 1) + (size_t)BK * dh + (size_t)BQ * LDS + BK) * sizeof(float);
    auto kern = mea_attention_kernel<BF16, DHP>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + BQ - 1) / BQ, B * H);
    kern<<<grid, NT, smem, stream>>>(q, k, v, (const float*)pad, out, L, H, dh, scale);
    return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, const void* pad, void* out, int B,
             int L, int H, int dh, float scale, cudaStream_t stream) {
    if (dh <= 32) return launch<BF16, 32>(q, k, v, pad, out, B, L, H, dh, scale, stream);
    if (dh <= 64) return launch<BF16, 64>(q, k, v, pad, out, B, L, H, dh, scale, stream);
    return launch<BF16, 128>(q, k, v, pad, out, B, L, H, dh, scale, stream);
}

}  // namespace

// q, k, v, out (B, L, H, dh) contiguous, bf16 (is_bf16 = 1) or f32; pad
// (B, L) f32, 1 = live key; scale = 1 / sqrt(dh).  dh % 8 == 0, dh <= 128,
// L >= 1, B * H <= 65535 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int mea_attention(const void* q, const void* k, const void* v, const void* pad,
                             int is_bf16, int B, int L, int H, int dh, float scale, void* out,
                             void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) return dispatch<true>(q, k, v, pad, out, B, L, H, dh, scale, s);
    return dispatch<false>(q, k, v, pad, out, B, L, H, dh, scale, s);
}
