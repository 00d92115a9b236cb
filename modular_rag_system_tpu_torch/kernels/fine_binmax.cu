// fine_binmax: the maxima probe of the ivf fine stage on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_binmax_kernel (via
// _fine_binmax_call).  For query i and its candidate block list blk/vcnt
// (Q, L) it writes
//
//     out[i, j] = max over r < vcnt[i, j] of
//                 bf16(q_i) . E_c3[blk[i, j], r]  (x scales3[blk, r] for int8, int4)
//
// and -inf for a dead slot (vcnt 0), as (Q, L) f32.  It does the reads and
// the dots of fine_scores.cu and fine_topk.cu with no selection and almost
// no output, so its time is the streaming floor beside which those two are
// read; it is on no serving path.
//
// Bound: memory, the probed slabs once each.  Design: fine_scores.cu's CTA,
// one per (query, slot), with a maximum in place of the store: each warp
// keeps the maximum of the rows it scored, and the 8 warps' maxima meet in
// shared memory.

#include "fine_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int ROWS = 4;

template <int MODE>
__global__ void __launch_bounds__(NT)
fine_binmax_kernel(const uint4* __restrict__ E_c3, const float* __restrict__ scales3,
                   const uint16_t* __restrict__ q_bf16, const int32_t* __restrict__ blk,
                   const int32_t* __restrict__ vcnt, int L, int d, float* __restrict__ out) {
    __shared__ float qs[1024];
    __shared__ float wmax[NWARPS];
    const int j = blockIdx.x, i = blockIdx.y;
    const size_t slot = (size_t)i * L + j;
    const int vc = min(vcnt[slot], fine::SLAB);
    if (vc <= 0) {  // a dead slot reads nothing
        if (threadIdx.x == 0) out[slot] = -INFINITY;
        return;
    }
    const int b = blk[slot];
    fine::load_query(q_bf16 + (size_t)i * d, d, qs);
    __syncthreads();

    constexpr int NOUT = fine::outputs<MODE, ROWS>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nvec = fine::row_vectors<MODE>(d);
    const uint4* slab = E_c3 + (size_t)b * fine::stored_slab<MODE>() * nvec;
    const int rlim = fine::stored_rows<MODE>(vc);
    float best = -INFINITY;  // of the rows this lane owns
    for (int r0 = warp * ROWS; r0 < rlim; r0 += NWARPS * ROWS) {
        float acc[NOUT];
        fine::score_rows<MODE, ROWS>(slab, nvec, r0, rlim, qs, lane, acc);
        const int r = fine::logical_row<ROWS>(r0, lane);
        if (lane < NOUT && r0 + lane % ROWS < rlim && r < vc) {
            const float a = fine::pick<NOUT>(acc, lane);
            best = fmaxf(best, MODE == fine::BF16 ? a : a * scales3[(size_t)b * fine::SLAB + r]);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) wmax[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = wmax[0];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, wmax[w]);
        out[slot] = m;
    }
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128, d)
// packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused for
// bf16), q_bf16 (Q, d) bf16 bits, blk/vcnt (Q, L) int32, out (Q, L) f32.
// d % 16 == 0, d <= 1024, Q <= 65535 (checked by the Python wrapper).
// Returns the launch's cudaError_t.
extern "C" int fine_binmax(const void* E_c3, int mode, const void* scales3,
                           const void* q_bf16, const void* blk, const void* vcnt, int Q,
                           int L, int d, void* out, void* stream) {
    const dim3 grid(L, Q);
    const cudaStream_t s = (cudaStream_t)stream;
    auto kern = mode == fine::INT4   ? fine_binmax_kernel<fine::INT4>
                : mode == fine::INT8 ? fine_binmax_kernel<fine::INT8>
                                     : fine_binmax_kernel<fine::BF16>;
    kern<<<grid, NT, 0, s>>>((const uint4*)E_c3, (const float*)scales3,
                             (const uint16_t*)q_bf16, (const int32_t*)blk,
                             (const int32_t*)vcnt, L, d, (float*)out);
    return (int)cudaGetLastError();
}
