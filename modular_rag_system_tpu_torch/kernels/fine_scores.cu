// fine_scores: the ivf fine stage's score dump on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_scores_kernel (via
// fine_scores_call).  For query i and its candidate block list
// blk/vcnt (Q, L) it writes
//
//     out[i, j * SLAB + r] = bf16(q_i) . E_c3[blk[i, j], r]  (x scales3[blk, r] for int8)
//
// for r < vcnt[i, j], and -inf for r >= vcnt[i, j], as (Q, L * SLAB) f32.
// The fine copy E_c3 (nblocks, SLAB, d) is bf16 or int8 with per-row f32
// scales; products are summed in f32 and an int8 row is scaled after its
// dot, as in the TPU kernel.
//
// Bound: memory.  The card must read the probed slabs (the union over the
// batch's queries, each slab once) and write Q * L * SLAB * 4 bytes of
// scores; the operations (2 * Q * L * SLAB * d) are far below the tensor
// cores' rate.  Design: one CTA per (query, slot), 8 warps of 32 rows,
// each warp with four rows in flight as 16-byte vector loads, the query in
// shared memory (fine_common.cuh); a slot whose vcnt is 0 writes -inf and
// reads nothing (the TPU kernel still fetched block 0 for it), and rows
// past vcnt are not read.  A slab probed by several queries of a batch is
// read once per query, from L2 when it is still there: keeping a hot
// cluster's slabs in shared memory across queries is left to a later
// version.

#include "fine_common.cuh"

namespace {

constexpr int NT = fine::SLAB;  // one thread per slab row for the -inf fill
constexpr int NWARPS = NT / 32;
constexpr int ROWS = 4;

template <bool INT8>
__global__ void __launch_bounds__(NT)
fine_scores_kernel(const uint4* __restrict__ E_c3, const float* __restrict__ scales3,
                   const uint16_t* __restrict__ q_bf16, const int32_t* __restrict__ blk,
                   const int32_t* __restrict__ vcnt, int L, int d, float* __restrict__ out) {
    __shared__ float qs[1024];
    const int j = blockIdx.x, i = blockIdx.y;
    const size_t slot = (size_t)i * L + j;
    float* o = out + slot * fine::SLAB;
    const int vc = min(vcnt[slot], fine::SLAB);
    if (threadIdx.x >= vc) o[threadIdx.x] = -INFINITY;
    if (vc <= 0) return;  // a dead slot reads nothing
    const int b = blk[slot];
    fine::load_query(q_bf16 + (size_t)i * d, d, qs);
    __syncthreads();

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nvec = fine::row_vectors<INT8>(d);
    const uint4* slab = E_c3 + (size_t)b * fine::SLAB * nvec;
    for (int r0 = warp * ROWS; r0 < vc; r0 += NWARPS * ROWS) {
        float acc[ROWS];
        fine::score_rows<INT8, ROWS>(slab, nvec, r0, vc, qs, lane, acc);
        if (lane < ROWS && r0 + lane < vc) {
            float a = acc[0];
#pragma unroll
            for (int jj = 1; jj < ROWS; ++jj) a = lane == jj ? acc[jj] : a;
            const int r = r0 + lane;
            o[r] = INT8 ? a * scales3[(size_t)b * fine::SLAB + r] : a;
        }
    }
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (is_int8 = 0) or int8 (is_int8 = 1) with
// scales3 (nblocks, 256) f32 (unused for bf16), q_bf16 (Q, d) bf16 bits,
// blk/vcnt (Q, L) int32, out (Q, L * 256) f32.  d % 16 == 0, d <= 1024,
// L <= 2^31 - 1, Q <= 65535 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int fine_scores(const void* E_c3, int is_int8, const void* scales3,
                           const void* q_bf16, const void* blk, const void* vcnt, int Q,
                           int L, int d, void* out, void* stream) {
    const dim3 grid(L, Q);
    const cudaStream_t s = (cudaStream_t)stream;
    if (is_int8)
        fine_scores_kernel<true><<<grid, NT, 0, s>>>(
            (const uint4*)E_c3, (const float*)scales3, (const uint16_t*)q_bf16,
            (const int32_t*)blk, (const int32_t*)vcnt, L, d, (float*)out);
    else
        fine_scores_kernel<false><<<grid, NT, 0, s>>>(
            (const uint4*)E_c3, (const float*)scales3, (const uint16_t*)q_bf16,
            (const int32_t*)blk, (const int32_t*)vcnt, L, d, (float*)out);
    return (int)cudaGetLastError();
}
