// fused_topk: single-pass top-k over f32 or bf16 rows on Hopper.
//
// Replaces modular_rag_system_tpu/ops/fused_topk.py:_fused_kernel (via
// fused_topk_raw).  For each query q it scores every live row of E as
// bf16(q) . bf16(E[r]) with f32 accumulation (the TPU kernel's default
// precision: an f32 row is rounded to bf16 first, and every bf16 x bf16
// product is exact in f32), scores rows >= count as -inf, optionally
// reduces each bin of bin_width rows to its best (score, lowest row id),
// and keeps the top k by (score desc, id asc).
//
// Design: fused_topk_int8.cu's, over 16-byte vectors of 4 f32 or 8 bf16
// values.  One CTA per query streams the live prefix in chunks of
// candidates; shared memory holds the running best KP keys (KP = next
// power of two >= k) and the chunk's candidates; a candidate that cannot
// beat the current k-th key is dropped, a bin's candidate is its best row
// (atomicMin on its key), and a chunk with a survivor is bitonic-sorted
// (topk_common.cuh).  Each warp scores ROWS rows at a time with all their
// loads in flight, the query from shared memory, one shuffle reduction
// per row (float_rows.cuh, shared with rescan.cu).
//
// Bound: the card must read count*d*4 (f32) or *2 (bf16) bytes and do
// 2*Q*count*d operations.  The tiers send it capacities below 8192 rows
// (larger ones take the two-pass route), where one CTA per query reads the
// rows from L2; at those sizes launch and the serial per-CTA chain set the
// time, not the bound.  Several queries per CTA and mma tiles are the way
// to the bound.

#include "float_rows.cuh"

namespace {

using topk::EMPTY;
using topk::key_score;
using topk::make_key;

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;

// ROWS rows in flight per warp; VPL 16-byte vectors of a row per lane
// (d <= 1024: 256 f32 vectors or 128 bf16 vectors over 32 lanes)
template <bool BF16, int ROWS, int VPL>
__global__ void __launch_bounds__(NT)
fused_topk_kernel(const uint4* __restrict__ E, const uint16_t* __restrict__ q_bf16, int d,
                  int count, int ncand, int k, int KP, int T, int bin_width,
                  float* __restrict__ out_vals, int32_t* __restrict__ out_ids) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;
    float* qs = (float*)(smem + T);

    constexpr int EPV = BF16 ? 8 : 4;  // values per 16-byte vector
    const int qi = blockIdx.x;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int j = threadIdx.x; j < d; j += NT)
        qs[j] = __uint_as_float((uint32_t)q_bf16[(size_t)qi * d + j] << 16);
    for (int j = threadIdx.x; j < KP; j += NT) keys[j] = EMPTY;
    __syncthreads();

    const int nvec = d / EPV;
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
        for (int r0 = base * bin_width + warp * ROWS; r0 < row_end; r0 += NWARPS * ROWS) {
            const uint4* row[ROWS];
#pragma unroll
            for (int j = 0; j < ROWS; ++j)
                row[j] = E + (size_t)min(r0 + j, row_end - 1) * nvec;
            float acc[ROWS];
            frows::score_rows<BF16, ROWS, VPL>(row, nvec, qs, lane, acc);
            if (lane < ROWS && r0 + lane < row_end) {
                float a = acc[0];
#pragma unroll
                for (int j = 1; j < ROWS; ++j) a = lane == j ? acc[j] : a;
                const int r = r0 + lane;
                const unsigned long long key = make_key(a, r);
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

template <bool BF16, int ROWS, int VPL>
int launch(const void* E, const void* q_bf16, int Q, int cap, int d, int count, int k,
           int bin_width, void* out_vals, void* out_ids, cudaStream_t stream) {
    int KP = 1;
    while (KP < k) KP <<= 1;
    const int T = KP * 2 > 1024 ? KP * 2 : 1024;
    const size_t smem = (size_t)T * sizeof(unsigned long long) + (size_t)d * sizeof(float);
    auto kern = fused_topk_kernel<BF16, ROWS, VPL>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<Q, NT, smem, stream>>>((const uint4*)E, (const uint16_t*)q_bf16, d, count,
                                  cap / bin_width, k, KP, T, bin_width, (float*)out_vals,
                                  (int32_t*)out_ids);
    return (int)cudaGetLastError();
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), q_bf16 (Q, d) bf16
// bits, out_vals (Q, k) f32, out_ids (Q, k) int32.  d % 8 == 0, d <= 1024,
// cap % bin_width == 0, 1 <= k <= 8192 (checked by the Python wrapper).
// Slots with no candidate hold (-inf, INT32_MAX).  Returns the launch's
// cudaError_t.
extern "C" int fused_topk(const void* E, int is_bf16, const void* q_bf16, int Q, int cap,
                          int d, int count, int k, int bin_width, void* out_vals,
                          void* out_ids, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch<true, 4, 4>(E, q_bf16, Q, cap, d, count, k, bin_width, out_vals,
                                  out_ids, s);
    return launch<false, 2, 8>(E, q_bf16, Q, cap, d, count, k, bin_width, out_vals,
                               out_ids, s);
}
