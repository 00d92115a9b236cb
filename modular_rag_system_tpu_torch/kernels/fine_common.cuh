// Shared device code of the two ivf fine-stage kernels (fine_scores.cu,
// fine_topk.cu): one warp scores ROWS rows of a fine-copy slab against the
// query held in shared memory.
//
// A slab row is d bf16 values or d int8 values; lanes read it as 16-byte
// vectors (8 bf16 or 16 int8 values), all of the ROWS rows' vectors in
// flight before any is used, and one shuffle reduction per row leaves
// every row's dot, bf16(q) . row summed in f32, in every lane.  int8
// values convert exactly (topk::int8_to_float); the caller applies the
// row scale after the dot, as the TPU kernel does.

#pragma once

#include "topk_common.cuh"

namespace fine {

constexpr int SLAB = 256;  // rows per fine-copy block

// 16-byte vectors per row; d % 16 == 0 and d <= 1024 (Python wrapper)
template <bool INT8>
__device__ __forceinline__ int row_vectors(int d) { return INT8 ? d / 16 : d / 8; }

template <bool INT8>
__device__ __forceinline__ float vec_dot(const uint4& v, const float* qs, int vi) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float acc = 0.0f;
    if (INT8) {
        const float* qw = qs + 16 * vi;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                acc += qw[4 * i + b] * topk::int8_to_float((int32_t)w[i], b);
    } else {
        const float* qw = qs + 8 * vi;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            acc += qw[2 * i] * topk::bf16_lo(w[i]) + qw[2 * i + 1] * topk::bf16_hi(w[i]);
    }
    return acc;
}

// dots of rows [r0, r0 + ROWS) of ``slab`` (rows at or past ``rlim`` read
// nothing and give 0); every lane returns all ROWS dots
template <bool INT8, int ROWS>
__device__ __forceinline__ void score_rows(const uint4* __restrict__ slab, int nvec, int r0,
                                           int rlim, const float* qs, int lane,
                                           float (&acc)[ROWS]) {
    constexpr int VPL = INT8 ? 2 : 4;  // vectors of a row per lane at d <= 1024
    uint4 v[ROWS][VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int vi = lane + 32 * i;
            v[j][i] = (vi < nvec && r0 + j < rlim) ? slab[(size_t)(r0 + j) * nvec + vi]
                                                    : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int vi = lane + 32 * i;
        if (vi >= nvec) break;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) acc[j] += vec_dot<INT8>(v[j][i], qs, vi);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
}

// the query row as f32 in shared memory (bf16 bits in global memory)
__device__ __forceinline__ void load_query(const uint16_t* __restrict__ qb, int d, float* qs) {
    for (int j = threadIdx.x; j < d; j += blockDim.x)
        qs[j] = __uint_as_float((uint32_t)qb[j] << 16);
}

}  // namespace fine
