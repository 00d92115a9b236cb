// Shared device code of the ivf fine-stage kernels (fine_scores.cu,
// fine_topk.cu, fine_binmax.cu): one warp scores ROWS stored rows of a
// fine-copy slab against a query held in shared memory, in two halves:
// load_rows brings the rows into registers, dot_rows scores them against
// one query and may run again on the same rows for another query.
//
// Three storage modes.  BF16 and INT8: a stored row is a logical row of d
// bf16 or d int8 values.  INT4: a block stores SLAB / 2 rows of d bytes,
// and byte j of stored row p holds logical row p's value j in its high
// nibble and logical row p + SLAB / 2's in its low nibble (each a 4-bit
// two's complement value in [-7, 7]), so one read of a stored row gives two
// dots and the slab's bytes are read once.  Lanes read a stored row as
// 16-byte vectors (8 bf16 values, or 16 bytes), all of the ROWS rows'
// vectors in flight before any is used, and one shuffle reduction per dot
// leaves every dot, bf16(q) . row summed in f32, in every lane.  int8 and
// int4 values convert exactly (topk_common.cuh); the caller applies the
// logical row's scale after the dot, as the TPU kernel does.

#pragma once

#include "topk_common.cuh"

namespace fine {

constexpr int SLAB = 256;  // logical rows per fine-copy block
constexpr int BF16 = 0, INT8 = 1, INT4 = 2;

// stored rows per block
template <int MODE>
__host__ __device__ constexpr int stored_slab() { return MODE == INT4 ? SLAB / 2 : SLAB; }

// stored rows that hold a logical row below vc
template <int MODE>
__device__ __forceinline__ int stored_rows(int vc) {
    return MODE == INT4 ? min(vc, SLAB / 2) : vc;
}

// dots that score_rows returns for ROWS stored rows
template <int MODE, int ROWS>
__host__ __device__ constexpr int outputs() { return MODE == INT4 ? 2 * ROWS : ROWS; }

// the logical row of output ``o`` of the group that starts at stored row
// r0: outputs [0, ROWS) are the stored rows themselves (the high nibbles),
// outputs [ROWS, 2 ROWS) the low nibbles' rows
template <int ROWS>
__device__ __forceinline__ int logical_row(int r0, int o) {
    return r0 + o % ROWS + (o / ROWS) * (SLAB / 2);
}

// 16-byte vectors per stored row; d % 16 == 0 and d <= 1024 (Python wrapper)
template <int MODE>
__device__ __forceinline__ int row_vectors(int d) { return MODE == BF16 ? d / 8 : d / 16; }

// acc[o] = output o of N, for a lane-dependent o (register arrays cannot be
// indexed by a runtime value)
template <int N>
__device__ __forceinline__ float pick(const float (&acc)[N], int o) {
    float a = acc[0];
#pragma unroll
    for (int j = 1; j < N; ++j) a = o == j ? acc[j] : a;
    return a;
}

template <int MODE>
__device__ __forceinline__ float vec_dot(const uint4& v, const float* qs, int vi) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float acc = 0.0f;
    if (MODE == INT8) {
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

// the two dots of a vector of packed int4 bytes: high and low nibbles
__device__ __forceinline__ void vec_dot_int4(const uint4& v, const float* qs, int vi,
                                             float& hi, float& lo) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float* qw = qs + 16 * vi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t h = topk::hi_nibbles(w[i]), l = topk::lo_nibbles(w[i]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            hi += qw[4 * i + b] * topk::nibble_to_float(h, b);
            lo += qw[4 * i + b] * topk::nibble_to_float(l, b);
        }
    }
}

// 16-byte vectors of a stored row that one lane holds at d <= 1024
template <int MODE>
__host__ __device__ constexpr int lane_vectors() { return MODE == BF16 ? 4 : 2; }

// the load half of score_rows: stored rows [r0, r0 + ROWS) of ``slab`` into
// the lane's registers, every vector in flight before any is used (stored
// rows at or past ``rlim`` read nothing and hold 0)
template <int MODE, int ROWS>
__device__ __forceinline__ void load_rows(const uint4* __restrict__ slab, int nvec, int r0,
                                          int rlim, int lane,
                                          uint4 (&v)[ROWS][lane_vectors<MODE>()]) {
#pragma unroll
    for (int i = 0; i < lane_vectors<MODE>(); ++i)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int vi = lane + 32 * i;
            v[j][i] = (vi < nvec && r0 + j < rlim) ? slab[(size_t)(r0 + j) * nvec + vi]
                                                    : make_uint4(0, 0, 0, 0);
        }
}

// the dot half of score_rows: the dots of the ROWS rows held in ``v`` with
// the query ``qs`` (each row's per-vector dots summed over the lane's
// vectors, then the butterfly); every lane returns all the dots, in the
// order of ``logical_row``.  A caller may run it on the same rows for
// several queries: a dot depends on its own row's vectors and the query
// only, so it is the same bits whichever rows and queries it is run beside.
template <int MODE, int ROWS>
__device__ __forceinline__ void dot_rows(const uint4 (&v)[ROWS][lane_vectors<MODE>()], int nvec,
                                         const float* qs, int lane,
                                         float (&acc)[outputs<MODE, ROWS>()]) {
    constexpr int NOUT = outputs<MODE, ROWS>();
#pragma unroll
    for (int j = 0; j < NOUT; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < lane_vectors<MODE>(); ++i) {
        const int vi = lane + 32 * i;
        if (vi >= nvec) break;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (MODE == INT4)
                vec_dot_int4(v[j][i], qs, vi, acc[j], acc[NOUT - ROWS + j]);
            else
                acc[j] += vec_dot<MODE>(v[j][i], qs, vi);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < NOUT; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
}

// dots of stored rows [r0, r0 + ROWS) of ``slab`` (stored rows at or past
// ``rlim`` read nothing and give 0): load_rows, then dot_rows
template <int MODE, int ROWS>
__device__ __forceinline__ void score_rows(const uint4* __restrict__ slab, int nvec, int r0,
                                           int rlim, const float* qs, int lane,
                                           float (&acc)[outputs<MODE, ROWS>()]) {
    uint4 v[ROWS][lane_vectors<MODE>()];
    load_rows<MODE, ROWS>(slab, nvec, r0, rlim, lane, v);
    dot_rows<MODE, ROWS>(v, nvec, qs, lane, acc);
}

// the query row as f32 in shared memory (bf16 bits in global memory)
__device__ __forceinline__ void load_query(const uint16_t* __restrict__ qb, int d, float* qs) {
    for (int j = threadIdx.x; j < d; j += blockDim.x)
        qs[j] = __uint_as_float((uint32_t)qb[j] << 16);
}

}  // namespace fine
