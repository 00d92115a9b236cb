// fine_topk: the ivf fine stage's selecting kernel on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_kernel (via fine_call).
// For query i it scores the rows of its candidate slabs blk/vcnt (Q, L) as
// fine_scores.cu does (bf16(q) . row in f32, int8 and int4 rows x their
// scale, rows past vcnt skipped) and keeps the top k by (score desc, slot asc), slot
// = blk * 256 + row: vals (Q, k) f32 and slots (Q, k) int32, -1 where
// fewer than k rows scored.  The engine reaches it at deep nprobe, when
// the score dump would pass its buffer limits (never with an int4 copy,
// whose per-slot bias needs the dump; that mode is for direct callers).
//
// Bound: memory, as fine_scores: the probed slabs once each, the output
// is tiny.  Design: the TPU kernel walks a query's L slabs on its
// sequential grid; here G CTAs share one query's list (G from the wrapper,
// enough CTAs to fill the card), each keeps a running top-k in shared
// memory over (score, slot) keys (topk_common.cuh): a chunk of S slabs is
// scored into the candidate region by 16 warps, a candidate that cannot
// beat the current k-th key is dropped, and a chunk with a survivor is
// bitonic-sorted.  Each CTA writes its sorted k keys, and a second launch,
// one CTA per query, merges the G partial lists.

#include "fine_common.cuh"

namespace {

using topk::EMPTY;

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
constexpr int ROWS = 4;

template <int MODE>
__global__ void __launch_bounds__(NT)
fine_topk_kernel(const uint4* __restrict__ E_c3, const float* __restrict__ scales3,
                 const uint16_t* __restrict__ q_bf16, const int32_t* __restrict__ blk,
                 const int32_t* __restrict__ vcnt, int L, int d, int k, int KP, int T, int G,
                 unsigned long long* __restrict__ part) {
    extern __shared__ unsigned long long smem[];
    const int S = (T - KP) / fine::SLAB;  // slabs per chunk
    unsigned long long* keys = smem;
    float* qs = (float*)(smem + T);
    int* sblk = (int*)(qs + d);
    int* svc = sblk + S;

    const int g = blockIdx.x, i = blockIdx.y;
    const int per = (L + G - 1) / G;
    const int j_begin = g * per, j_end = min(L, j_begin + per);
    fine::load_query(q_bf16 + (size_t)i * d, d, qs);
    for (int j = threadIdx.x; j < KP; j += NT) keys[j] = EMPTY;
    __syncthreads();

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nvec = fine::row_vectors<MODE>(d);
    constexpr int NOUT = fine::outputs<MODE, ROWS>();
    constexpr int PR = fine::stored_slab<MODE>();  // stored rows per slab
    for (int js = j_begin; js < j_end; js += S) {
        const unsigned long long kth = keys[k - 1];
        for (int c = threadIdx.x; c < T - KP; c += NT) keys[KP + c] = EMPTY;
        for (int u = threadIdx.x; u < S; u += NT) {
            const bool in = js + u < j_end;
            svc[u] = in ? min(vcnt[(size_t)i * L + js + u], fine::SLAB) : 0;
            sblk[u] = in ? blk[(size_t)i * L + js + u] : 0;
        }
        __syncthreads();
        bool any = false;
        // groups of ROWS stored rows of the chunk's S slabs
        for (int gi = warp; gi < S * PR / ROWS; gi += NWARPS) {
            const int u = gi * ROWS / PR, r0 = gi * ROWS % PR;
            const int vc = svc[u];
            const int rlim = fine::stored_rows<MODE>(vc);
            if (r0 >= rlim) continue;
            const int b = sblk[u];
            float acc[NOUT];
            fine::score_rows<MODE, ROWS>(E_c3 + (size_t)b * PR * nvec, nvec, r0, rlim, qs,
                                         lane, acc);
            const int r = fine::logical_row<ROWS>(r0, lane);
            if (lane < NOUT && r0 + lane % ROWS < rlim && r < vc) {
                float a = fine::pick<NOUT>(acc, lane);
                if (MODE != fine::BF16) a *= scales3[(size_t)b * fine::SLAB + r];
                const unsigned long long key = topk::make_key(a, b * fine::SLAB + r);
                if (key < kth) {
                    keys[KP + u * fine::SLAB + r] = key;
                    any = true;
                }
            }
        }
        if (__syncthreads_or(any)) topk::bitonic_sort<NT>(keys, T);
    }
    unsigned long long* dst = part + ((size_t)i * G + g) * k;
    for (int t = threadIdx.x; t < k; t += NT) dst[t] = keys[t];
}

// one CTA per query: the best k of its G sorted partial lists
__global__ void __launch_bounds__(NT)
fine_topk_merge(const unsigned long long* __restrict__ part, int G, int k, int T2,
                float* __restrict__ vals, int32_t* __restrict__ slots) {
    extern __shared__ unsigned long long keys[];
    const int i = blockIdx.x;
    const int n = G * k;
    for (int x = threadIdx.x; x < T2; x += NT) keys[x] = x < n ? part[(size_t)i * n + x] : EMPTY;
    __syncthreads();
    topk::bitonic_sort<NT>(keys, T2);
    for (int t = threadIdx.x; t < k; t += NT) {
        const unsigned long long key = keys[t];
        const bool empty = key == EMPTY;
        vals[(size_t)i * k + t] = empty ? -INFINITY : topk::key_score(key);
        slots[(size_t)i * k + t] = empty ? -1 : (int32_t)(uint32_t)key;
    }
}

int next_pow2(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128, d)
// packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused for
// bf16), q_bf16 (Q, d) bf16 bits,
// blk/vcnt (Q, L) int32, G CTAs per query, part (Q, G, k) uint64 scratch,
// vals (Q, k) f32, slots (Q, k) int32.  d % 16 == 0, d <= 1024,
// 1 <= k <= 8192, G * next_pow2(k) <= 4096, Q <= 65535 (checked by the
// Python wrapper).  Returns the first launch error as a cudaError_t.
extern "C" int fine_topk(const void* E_c3, int mode, const void* scales3,
                         const void* q_bf16, const void* blk, const void* vcnt, int Q, int L,
                         int d, int k, int G, void* part, void* vals, void* slots,
                         void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int KP = next_pow2(k);
    const int T = 2 * KP > 2048 ? 2 * KP : 2048;
    const int S = (T - KP) / fine::SLAB;
    const size_t smem = (size_t)T * 8 + (size_t)d * 4 + (size_t)S * 8;
    auto kern = mode == fine::INT4   ? fine_topk_kernel<fine::INT4>
                : mode == fine::INT8 ? fine_topk_kernel<fine::INT8>
                                     : fine_topk_kernel<fine::BF16>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(G, Q), NT, smem, s>>>((const uint4*)E_c3, (const float*)scales3,
                                      (const uint16_t*)q_bf16, (const int32_t*)blk,
                                      (const int32_t*)vcnt, L, d, k, KP, T, G,
                                      (unsigned long long*)part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int T2 = next_pow2(G * k);
    const size_t smem2 = (size_t)T2 * 8;
    err = cudaFuncSetAttribute(fine_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem2);
    if (err != cudaSuccess) return (int)err;
    fine_topk_merge<<<Q, NT, smem2, s>>>((const unsigned long long*)part, G, k, T2,
                                         (float*)vals, (int32_t*)slots);
    return (int)cudaGetLastError();
}
