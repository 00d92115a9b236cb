// fine_scores: the ivf fine stage's score dump on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_scores_kernel (via
// fine_scores_call).  For query i and its candidate block list
// blk/vcnt (Q, L) it writes
//
//     out[i, j * SLAB + r] = bf16(q_i) . E_c3[blk[i, j], r]  (x scales3[blk, r] for int8, int4)
//
// for r < vcnt[i, j], and -inf for r >= vcnt[i, j], as (Q, L * SLAB) f32.
// The fine copy E_c3 is (nblocks, SLAB, d) bf16 or int8, or (nblocks,
// SLAB / 2, d) bytes of two int4 rows each (fine_common.cuh), with per-row
// f32 scales for int8 and int4; products are summed in f32 and a quantized
// row is scaled after its dot, as in the TPU kernel.
//
// Bound: memory.  The card must read the probed slabs (the union over the
// batch's queries, each slab once) and write Q * L * SLAB * 4 bytes of
// scores; the operations (2 * Q * L * SLAB * d) are far below the tensor
// cores' rate.  Design: one CTA per (query, slot), 8 warps, each warp with
// four stored rows in flight as 16-byte vector loads, the query in shared
// memory (fine_common.cuh); a slot whose vcnt is 0 writes -inf and reads
// nothing (the TPU kernel still fetched block 0 for it), and rows past
// vcnt are not read.  An int4 slab is half the bytes of an int8 one and
// each stored row gives two scores.  A slab probed by several queries of a
// batch is read once per query, from L2 when it is still there: keeping a
// hot cluster's slabs in shared memory across queries is left to a later
// version.

#include "fine_common.cuh"

namespace {

constexpr int NT = fine::SLAB;  // one thread per slab row for the -inf fill
constexpr int NWARPS = NT / 32;
constexpr int ROWS = 4;

template <int MODE>
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

    constexpr int NOUT = fine::outputs<MODE, ROWS>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nvec = fine::row_vectors<MODE>(d);
    const uint4* slab = E_c3 + (size_t)b * fine::stored_slab<MODE>() * nvec;
    const int rlim = fine::stored_rows<MODE>(vc);
    for (int r0 = warp * ROWS; r0 < rlim; r0 += NWARPS * ROWS) {
        float acc[NOUT];
        fine::score_rows<MODE, ROWS>(slab, nvec, r0, rlim, qs, lane, acc);
        const int r = fine::logical_row<ROWS>(r0, lane);
        if (lane < NOUT && r0 + lane % ROWS < rlim && r < vc) {
            const float a = fine::pick<NOUT>(acc, lane);
            o[r] = MODE == fine::BF16 ? a : a * scales3[(size_t)b * fine::SLAB + r];
        }
    }
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128, d)
// packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused for
// bf16), q_bf16 (Q, d) bf16 bits, blk/vcnt (Q, L) int32, out (Q, L * 256)
// f32.  d % 16 == 0, d <= 1024, L <= 2^31 - 1, Q <= 65535 (checked by the
// Python wrapper).  Returns the launch's cudaError_t.
extern "C" int fine_scores(const void* E_c3, int mode, const void* scales3,
                           const void* q_bf16, const void* blk, const void* vcnt, int Q,
                           int L, int d, void* out, void* stream) {
    const dim3 grid(L, Q);
    const cudaStream_t s = (cudaStream_t)stream;
    auto kern = mode == fine::INT4   ? fine_scores_kernel<fine::INT4>
                : mode == fine::INT8 ? fine_scores_kernel<fine::INT8>
                                     : fine_scores_kernel<fine::BF16>;
    kern<<<grid, NT, 0, s>>>((const uint4*)E_c3, (const float*)scales3,
                             (const uint16_t*)q_bf16, (const int32_t*)blk,
                             (const int32_t*)vcnt, L, d, (float*)out);
    return (int)cudaGetLastError();
}
