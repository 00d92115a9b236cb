// rescan: pass 2 of the two-pass top-k on Hopper, in one kernel.
//
// Replaces modular_rag_system_tpu/ops/binmax_topk.py:_rescan_kernel (via
// rescan_call).  For query i and its kb candidate bins (Q, kb), each
// bin_width consecutive rows of the store E (cap, d) f32 or bf16, it scores
// every row of those bins as bf16(q_i) . bf16(row) summed in f32 (the TPU
// kernel's default precision, on an f32 store too: fused_topk.cu's
// arithmetic, float_rows.cuh), drops rows >= count, and keeps the top k by
// (score desc, row id asc): vals (Q, k) f32 and ids (Q, k) int32, with
// (-inf, -1) where fewer than k live rows were scanned.  It takes the
// place of the gather of the bins' rows into a (Q, kb * bin_width, d)
// tensor, the batched product and the sort.
//
// Bound: memory, Q * kb bins of bin_width rows read once; the rows of one
// bin are contiguous, so a warp's 16-byte loads are whole rows.  Design:
// one CTA per query; its candidates (kb * bin_width, a few thousand at
// most) all become (score, id) keys in shared memory, one bitonic sort
// (topk_common.cuh) orders them, and the first k are written.

#include "float_rows.cuh"

namespace {

using topk::EMPTY;

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;

template <bool BF16, int ROWS, int VPL>
__global__ void __launch_bounds__(NT)
rescan_kernel(const uint4* __restrict__ E, const uint16_t* __restrict__ q_bf16,
              const int32_t* __restrict__ bins, int d, int count, int kb, int bin_width, int k,
              int T, float* __restrict__ out_vals, int32_t* __restrict__ out_ids) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;
    float* qs = (float*)(smem + T);

    constexpr int EPV = BF16 ? 8 : 4;  // values per 16-byte vector
    const int qi = blockIdx.x;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int j = threadIdx.x; j < d; j += NT)
        qs[j] = __uint_as_float((uint32_t)q_bf16[(size_t)qi * d + j] << 16);
    for (int j = threadIdx.x; j < T; j += NT) keys[j] = EMPTY;
    __syncthreads();

    const int nvec = d / EPV;
    const int n = kb * bin_width;  // candidates of this query
    const int32_t* qbins = bins + (size_t)qi * kb;
    for (int c0 = warp * ROWS; c0 < n; c0 += NWARPS * ROWS) {
        const uint4* row[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int c = min(c0 + j, n - 1);
            row[j] = E + ((size_t)qbins[c / bin_width] * bin_width + c % bin_width) * nvec;
        }
        float acc[ROWS];
        frows::score_rows<BF16, ROWS, VPL>(row, nvec, qs, lane, acc);
        if (lane < ROWS && c0 + lane < n) {
            float a = acc[0];
#pragma unroll
            for (int j = 1; j < ROWS; ++j) a = lane == j ? acc[j] : a;
            const int c = c0 + lane;
            const int gid = qbins[c / bin_width] * bin_width + c % bin_width;
            if (gid < count) keys[c] = topk::make_key(a, gid);
        }
    }
    __syncthreads();
    topk::bitonic_sort<NT>(keys, T);
    for (int j = threadIdx.x; j < k; j += NT) {
        const unsigned long long key = j < T ? keys[j] : EMPTY;
        const bool empty = key == EMPTY;
        out_vals[(size_t)qi * k + j] = empty ? -INFINITY : topk::key_score(key);
        out_ids[(size_t)qi * k + j] = empty ? -1 : (int32_t)(uint32_t)key;
    }
}

template <bool BF16, int ROWS, int VPL>
int launch(const void* E, const void* q_bf16, const void* bins, int Q, int d, int count,
           int kb, int bin_width, int k, void* out_vals, void* out_ids, cudaStream_t stream) {
    int T = 2;
    while (T < kb * bin_width) T <<= 1;
    const size_t smem = (size_t)T * sizeof(unsigned long long) + (size_t)d * sizeof(float);
    auto kern = rescan_kernel<BF16, ROWS, VPL>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<Q, NT, smem, stream>>>((const uint4*)E, (const uint16_t*)q_bf16,
                                  (const int32_t*)bins, d, count, kb, bin_width, k, T,
                                  (float*)out_vals, (int32_t*)out_ids);
    return (int)cudaGetLastError();
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), q_bf16 (Q, d) bf16
// bits, bins (Q, kb) int32 bin ids in [0, cap / bin_width), distinct per
// query, out_vals (Q, k) f32, out_ids (Q, k) int32.  d % 8 == 0, d <= 1024,
// 1 <= kb * bin_width <= 16384, k >= 1 (checked by the Python wrapper).
// Returns the launch's cudaError_t.
extern "C" int rescan(const void* E, int is_bf16, const void* q_bf16, const void* bins, int Q,
                      int d, int count, int kb, int bin_width, int k, void* out_vals,
                      void* out_ids, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch<true, 4, 4>(E, q_bf16, bins, Q, d, count, kb, bin_width, k, out_vals,
                                  out_ids, s);
    return launch<false, 2, 8>(E, q_bf16, bins, Q, d, count, kb, bin_width, k, out_vals,
                               out_ids, s);
}
