// Shared device code of the kernels that score f32 or bf16 store rows
// (fused_topk.cu, rescan.cu): one warp scores ROWS rows against the query
// held in shared memory as f32 (bf16 values).
//
// A score is bf16(q) . bf16(row) summed in f32, the TPU kernels' default
// precision: an f32 row is rounded to bf16 first, and every bf16 x bf16
// product is exact in f32.  Lanes read a row as 16-byte vectors (4 f32 or
// 8 bf16 values), all of the ROWS rows' vectors in flight before any is
// used, and one shuffle reduction per row leaves every row's dot in every
// lane.

#pragma once

#include "topk_common.cuh"

namespace frows {

// dot of a 16-byte vector of row values with the matching query values
template <bool BF16>
__device__ __forceinline__ float vec_dot(const uint4& v, const float* qw) {
    if (BF16) {
        return qw[0] * topk::bf16_lo(v.x) + qw[1] * topk::bf16_hi(v.x) +
               qw[2] * topk::bf16_lo(v.y) + qw[3] * topk::bf16_hi(v.y) +
               qw[4] * topk::bf16_lo(v.z) + qw[5] * topk::bf16_hi(v.z) +
               qw[6] * topk::bf16_lo(v.w) + qw[7] * topk::bf16_hi(v.w);
    }
    return qw[0] * topk::round_bf16(__uint_as_float(v.x)) +
           qw[1] * topk::round_bf16(__uint_as_float(v.y)) +
           qw[2] * topk::round_bf16(__uint_as_float(v.z)) +
           qw[3] * topk::round_bf16(__uint_as_float(v.w));
}

// dots of the ROWS rows at ``row``; VPL 16-byte vectors of a row per lane
// (d <= 1024: 256 f32 vectors or 128 bf16 vectors over 32 lanes), nvec
// vectors per row; every lane returns all ROWS dots
template <bool BF16, int ROWS, int VPL>
__device__ __forceinline__ void score_rows(const uint4* (&row)[ROWS], int nvec,
                                           const float* qs, int lane, float (&acc)[ROWS]) {
    constexpr int EPV = BF16 ? 8 : 4;  // values per 16-byte vector
    // all of the rows' vectors are loaded before any is used
    uint4 v[ROWS][VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
            v[j][i] = lane + 32 * i < nvec ? row[j][lane + 32 * i] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        if (lane + 32 * i >= nvec) break;
        const float* qw = qs + EPV * (lane + 32 * i);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) acc[j] += vec_dot<BF16>(v[j][i], qw);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
}

}  // namespace frows
