// fused_topk_int8: single-pass int8 search with a running top-k on Hopper.
//
// Replaces modular_rag_system_tpu/ops/fused_topk.py:_fused_kernel_int8 (via
// fused_topk_int8_raw).  For each query q (bf16) it scores every live row of
// the int8 index as  (q . float(E_q[r])) * scale[r]  with f32 accumulation
// (each product is exact in f32: an 8-bit significand times a 7-bit integer),
// scores rows >= count as -inf, optionally reduces each bin of bin_width rows
// to its best (score, lowest row id), and keeps the top k by (score desc,
// id asc), the TPU kernel's order.
//
// Design.  One CTA per query streams the live prefix in chunks of
// candidates.  A (score, id) pair is packed into one 64-bit key whose
// ascending order is (score desc, id asc), so selection is a plain sort of
// unique keys (topk_common.cuh, shared with fused_topk.cu and
// fine_topk.cu).  Shared memory holds T keys: the running best KP (KP =
// next power of two >= k) in [0, KP) and the chunk's candidates in [KP, T).  A
// candidate that does not beat the current k-th key stays the empty key,
// and when no candidate of a chunk survives the chunk is not sorted;
// otherwise a bitonic sort of all T keys makes [0, KP) the new running
// best.  Each warp scores four rows at a time (int32 loads of four int8
// values each, all in flight together, the query from shared memory, one
// shuffle reduction per row); a row's key goes to its bin's slot by a
// shared-memory atomicMin, so a bin's candidate is its best row.
//
// Bound: the card must read count*d bytes of rows per query batch (the rows
// stay in L2 across the CTAs of a batch) and do 2*Q*count*d operations; at
// serving batch sizes that is far below the bf16 tensor-core bound, so this
// first version runs on the CUDA cores and the query-per-CTA layout reads
// the rows once per query from L2.  Several queries per CTA and mma tiles
// are the way to the bound.

#include "topk_common.cuh"

namespace {

using topk::EMPTY;
using topk::int8_to_float;
using topk::key_score;
using topk::make_key;

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
constexpr int ROWS = 4;  // rows in flight per warp
constexpr int WPL = 8;   // int32 words of a row per lane: d <= 1024

__global__ void __launch_bounds__(NT)
fused_topk_int8_kernel(const int8_t* __restrict__ E_q, const float* __restrict__ scales,
                       const uint16_t* __restrict__ q_bf16, int d, int count, int ncand,
                       int k, int KP, int T, int bin_width, float* __restrict__ out_vals,
                       int32_t* __restrict__ out_ids) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;
    float* qs = (float*)(smem + T);

    const int qi = blockIdx.x;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int j = threadIdx.x; j < d; j += NT)
        qs[j] = __uint_as_float((uint32_t)q_bf16[(size_t)qi * d + j] << 16);
    for (int j = threadIdx.x; j < KP; j += NT) keys[j] = EMPTY;
    __syncthreads();

    const int dw = d / 4;
    const int C = T - KP;
    // candidates whose first row is live; rows >= count score -inf and
    // can never be a live bin's best, so they are not scored at all
    const int live = min(ncand, (count + bin_width - 1) / bin_width);
    for (int base = 0; base < live; base += C) {
        const unsigned long long kth = keys[k - 1];
        for (int c = threadIdx.x; c < C; c += NT) keys[KP + c] = EMPTY;
        __syncthreads();
        const int row_end = min(min(base + C, live) * bin_width, count);
        bool any = false;
        // each warp scores ROWS rows at a time, loads of all in flight
        for (int r0 = base * bin_width + warp * ROWS; r0 < row_end; r0 += NWARPS * ROWS) {
            float acc[ROWS];
            const int32_t* row[ROWS];
#pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                acc[j] = 0.0f;
                row[j] = (const int32_t*)(E_q + (size_t)min(r0 + j, row_end - 1) * d);
            }
            // all of the rows' words are loaded before any is used
            int32_t v[ROWS][WPL];
#pragma unroll
            for (int i = 0; i < WPL; ++i)
#pragma unroll
                for (int j = 0; j < ROWS; ++j)
                    v[j][i] = lane + 32 * i < dw ? row[j][lane + 32 * i] : 0;
#pragma unroll
            for (int i = 0; i < WPL; ++i) {
                if (lane + 32 * i >= dw) break;
                const float* qw = qs + 4 * (lane + 32 * i);
#pragma unroll
                for (int j = 0; j < ROWS; ++j)
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        acc[j] += qw[b] * int8_to_float(v[j][i], b);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
#pragma unroll
                for (int j = 0; j < ROWS; ++j)
                    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
            if (lane < ROWS && r0 + lane < row_end) {
                float a = acc[0];
#pragma unroll
                for (int j = 1; j < ROWS; ++j) a = lane == j ? acc[j] : a;
                const int r = r0 + lane;
                const unsigned long long key = make_key(a * scales[r], r);
                // a bin's candidate is its best row: min key over its rows
                if (key < kth) {
                    atomicMin(&keys[KP + r / bin_width - base], key);
                    any = true;
                }
            }
        }
        // the barrier also orders every atomicMin before the sort
        if (__syncthreads_or(any)) topk::bitonic_sort<NT>(keys, T);
    }

    for (int j = threadIdx.x; j < k; j += NT) {
        const unsigned long long key = keys[j];
        const bool empty = key == EMPTY;
        out_vals[(size_t)qi * k + j] = empty ? -INFINITY : key_score(key);
        out_ids[(size_t)qi * k + j] = empty ? 0x7FFFFFFF : (int32_t)(uint32_t)key;
    }
}

}  // namespace

// E_q (cap, d) int8, scales (cap,) f32, q_bf16 (Q, d) bf16 bits,
// out_vals (Q, k) f32, out_ids (Q, k) int32.  d % 4 == 0, d <= 1024, cap % bin_width
// == 0, 1 <= k <= 8192 (checked by the Python wrapper).  Slots with no
// candidate hold (-inf, INT32_MAX).  Returns the launch's cudaError_t.
extern "C" int fused_topk_int8(const void* E_q, const void* scales, const void* q_bf16,
                               int Q, int cap, int d, int count, int k, int bin_width,
                               void* out_vals, void* out_ids, void* stream) {
    int KP = 1;
    while (KP < k) KP <<= 1;
    const int T = KP * 2 > 1024 ? KP * 2 : 1024;
    const size_t smem = (size_t)T * sizeof(unsigned long long) + (size_t)d * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_topk_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_topk_int8_kernel<<<Q, NT, smem, (cudaStream_t)stream>>>(
        (const int8_t*)E_q, (const float*)scales, (const uint16_t*)q_bf16, d, count,
        cap / bin_width, k, KP, T, bin_width, (float*)out_vals, (int32_t*)out_ids);
    return (int)cudaGetLastError();
}
