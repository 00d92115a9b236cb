// rescan: pass 2 of the two-pass top-k on Hopper, a score launch and a
// select launch.
//
// Replaces modular_rag_system_tpu/ops/binmax_topk.py:_rescan_kernel (via
// rescan_call).  For query i and its kb candidate bins (Q, kb), each
// bin_width consecutive rows of the store E (cap, d) f32 or bf16, it scores
// every row of those bins as bf16(q_i) . bf16(row) summed in f32 (the TPU
// kernel's default precision, on an f32 store too), drops rows >= count,
// and keeps the top k by (score desc, row id asc): vals (Q, k) f32 and
// ids (Q, k) int32, with (-inf, -1) where fewer than k live rows were
// scanned.  It takes the place of the gather of the bins' rows into a
// (Q, kb * bin_width, d) tensor, the batched product and the sort.
//
// Bound: memory, each bin that any query lists read once.  Similar
// queries list the same bins: at the smoke's k = 100 inputs the per-query
// stream is 2.57 GB but the distinct bins 0.87 GB, and at k = 10 all 256
// queries land in the same 61 bins.  A design that reads a query's bins on
// its own CTA reads a bin once per query that lists it.
//
// Design.  The wrapper (ops/binmax_topk.py rescan_call) sorts the Q kb
// (query, bin) pairs by bin on the device (rescan_pairs).  The score
// launch is a persistent grid over windows of up to NCOL sorted pairs
// (pair_window; CTA b takes windows b, b + G, ...); a run is a window's pairs that list one
// bin, found by one load of the window's keys and a ballot, so a bin is
// read once for each run that lists it (at most the unique bins + one a
// window) and scored against the run's queries on mma.sync m16n8k16 bf16
// -> f32, the bin's rows as A (bin_width / 16 row
// tiles; an f32 value rounded to bf16, ties to even, as its A fragment is
// formed, as fused_topk.cu does), the queries as one n8 column tile.  The
// depth is split across the 8 warps: warp w owns a slice of the k16 steps
// and loads, with 16-byte cp.async copies, only its slice of the rows and
// the queries into its own shared buffer (W columns a pass, the slice in
// as many passes as the budget needs: one or two at d = 768), so a warp
// waits on its own copies and on no block barrier; the 8 partial sums meet
// in shared memory in a fixed order.  Each (pair, row) leaves a packed
// (score, id) key (topk_common.cuh), EMPTY for ids >= count, in a (Q, kb
// bin_width) workspace at the pair's position.  The select launch keeps
// each query's best k keys: a warp per query selecting in registers
// (tile_common.cuh warp_select, 256 keys a round) where k <= 32, else one
// CTA per query sorting its keys (bitonic, topk_common.cuh).

#include <algorithm>

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int NT = 256;  // 8 warps
constexpr int NWARPS = NT / 32;
constexpr int NCOL = 8;  // pairs a chunk: one n8 column tile
constexpr int SEL_NT = 512;
constexpr int SMEM_MAX = 232448;
// a score CTA's shared memory: two CTAs an SM
constexpr int SCORE_BUDGET = 113 * 1024;

// bytes of one warp's buffer: bw rows x (W + 8) values of the bin and NCOL x
// (W + 8) bf16 query values (the rows padded by 8 values keep the fragment
// loads free of bank conflicts)
__host__ __device__ __forceinline__ int warp_bytes(int bw, int W, int es) {
    return (W + 8) * (bw * es + NCOL * 2);
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
rescan_score(const unsigned char* __restrict__ E, const uint16_t* __restrict__ qb,
             const void* __restrict__ keys, int kbytes, const long long* __restrict__ perm,
             int P, int NW, int kb, int bw, int d, int KS, int W, int count,
             u64* __restrict__ ws) {
    constexpr int ES = BF16 ? 2 : 4;  // bytes a value
    constexpr int EPV = 16 / ES;      // values a 16-byte copy
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
    const int LD = W + 8;            // values a row of a warp's buffer
    const int WB = warp_bytes(bw, W, ES);
    unsigned char* As = smem + (size_t)warp * WB;                       // bw x LD values
    uint16_t* Qs = reinterpret_cast<uint16_t*>(As + (size_t)bw * LD * ES);  // NCOL x LD bf16
    const int s0 = warp * KS / NWARPS, s1 = (warp + 1) * KS / NWARPS;  // the warp's k16 steps
    const int MT = bw / 16;
    const int PS = W / 16;  // k16 steps a pass

    for (int w0 = blockIdx.x * NW; w0 < P; w0 += gridDim.x * NW) {
        // lane j < nw: the window's pair j, its bin and its flat position
        const int nw = min(NW, P - w0);
        int wkey = -1, wpos = 0;
        if (lane < nw) {
            wkey = kbytes == 2 ? ((const int16_t*)keys)[w0 + lane]
                   : kbytes == 4 ? ((const int32_t*)keys)[w0 + lane]
                                 : (int)((const long long*)keys)[w0 + lane];
            wpos = perm ? (int)perm[w0 + lane] : w0 + lane;
        }
        for (int r0 = 0, r1; r0 < nw; r0 = r1) {
            // the run [r0, r1) of the window: the pairs that list one bin
            const int bin = __shfl_sync(0xffffffffu, wkey, r0);
            r1 = r0 + __ffs(~(__ballot_sync(0xffffffffu, lane < nw && wkey == bin) >> r0)) - 1;
            const int np = r1 - r0;
            // lane j < np holds the flat position and the query row of column j
            const int pos = __shfl_sync(0xffffffffu, wpos, min(r0 + lane, NCOL - 1));
            const int qrow = lane < np ? pos / kb : 0;
            const unsigned char* rows = E + (size_t)bin * bw * d * ES;

            float acc[4][4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
            for (int ps = s0; ps < s1; ps += PS) {
                const int pe = min(ps + PS, s1), k0 = 16 * ps;
                // the pass's columns [k0, 16 pe) of the bin's rows and of the
                // run's queries, zero past d and past the run's pairs
                const int va = (pe - ps) * 16 / EPV, vq = (pe - ps) * 2;
                for (int i = lane; i < bw * va; i += 32) {
                    const int r = i / va, k = k0 + (i % va) * EPV;
                    const bool ok = k < d;
                    cp_async16(As + ((size_t)r * LD + k - k0) * ES,
                               ok ? rows + ((size_t)r * d + k) * ES : E, ok);
                }
                for (int i0 = 0; i0 < NCOL * vq; i0 += 32) {  // uniform: the shuffle
                    const int i = i0 + lane, j = min(i / vq, NCOL - 1);
                    const int qr = __shfl_sync(0xffffffffu, qrow, j);
                    const int k = k0 + (i % vq) * 8;
                    const bool ok = i < NCOL * vq && j < np && k < d;
                    if (i < NCOL * vq)
                        cp_async16(Qs + (size_t)j * LD + k - k0,
                                   ok ? qb + (size_t)qr * d + k : qb, ok);
                }
                cp_async_commit();
                cp_async_wait<0>();
                __syncwarp();
    #pragma unroll 1
                for (int st = ps; st < pe; ++st) {
                    const int kq = 16 * (st - ps);
                    const uint16_t* qp = Qs + (size_t)g * LD + kq + 2 * t;
                    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qp);
                    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qp + 8);
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        if (m >= MT) break;
                        uint32_t a[4];
                        if (BF16) {
                            const uint16_t* A16 = reinterpret_cast<const uint16_t*>(As);
                            ldmatrix_x4(a, A16 + (size_t)(16 * m + (mat & 1) * 8 + r8) * LD + kq +
                                               (mat >> 1) * 8);
                        } else {
                            const float* Af = reinterpret_cast<const float*>(As) + kq + 2 * t;
                            const float2 x0 =
                    *reinterpret_cast<const float2*>(Af + (16 * m + g) * LD);
                            const float2 x1 =
                                *reinterpret_cast<const float2*>(Af + (16 * m + g + 8) * LD);
                            const float2 x2 =
                                *reinterpret_cast<const float2*>(Af + (16 * m + g) * LD + 8);
                            const float2 x3 =
                                *reinterpret_cast<const float2*>(Af + (16 * m + g + 8) * LD + 8);
                            a[0] = pack_bf16(x0.x, x0.y);
                            a[1] = pack_bf16(x1.x, x1.y);
                            a[2] = pack_bf16(x2.x, x2.y);
                            a[3] = pack_bf16(x3.x, x3.y);
                        }
                        mma_bf16(acc[m], a, b0, b1);
                    }
                }
                __syncwarp();  // the buffer is read by all lanes before it is loaded again
            }
            // the warp's partial sums into its own buffer: row r, column j at
            // float j of row r (a row holds at least 16 bf16 values)
            if (s1 > s0) {
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    if (m >= MT) break;
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = 16 * m + g + 8 * (e >> 1), j = 2 * t + (e & 1);
                        reinterpret_cast<float*>(As + (size_t)r * LD * ES)[j] = acc[m][e];
                    }
                }
            }
            __syncthreads();
            // the 8 partial sums in warp order, and the pairs' keys
            for (int o = tid; o < bw * NCOL; o += NT) {  // uniform: the shuffle
                const int r = o % bw, j = o / bw;
                const int p = __shfl_sync(0xffffffffu, pos, j);
                if (j >= np) continue;
                float sum = 0.0f;
                for (int w = 0; w < NWARPS; ++w)
                    if ((w + 1) * KS / NWARPS > w * KS / NWARPS)
                        sum += reinterpret_cast<const float*>(smem + (size_t)w * WB +
                                                              (size_t)r * LD * ES)[j];
                const int gid = bin * bw + r;
                ws[(size_t)p * bw + r] = gid < count ? topk::make_key(sum, gid) : EMPTY;
            }
            __syncthreads();  // the buffers are read before the next run loads them
        }
    }
}

// k <= 32: a warp per query; each round takes 256 of its n keys and the
// current best k (lane r holds the r-th) and keeps the best k
__global__ void __launch_bounds__(NT)
rescan_select_warp(const u64* __restrict__ ws, int Q, int n, int k, float* __restrict__ vals,
                   int32_t* __restrict__ ids) {
    const int lane = threadIdx.x & 31;
    const int qi = blockIdx.x * NWARPS + (threadIdx.x >> 5);
    if (qi >= Q) return;
    const u64* keys = ws + (size_t)qi * n;
    u64 mine = EMPTY;
    for (int b = 0; b < n; b += 256) {
        u64 v[9];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int x = b + 32 * i + lane;
            v[i] = x < n ? keys[x] : EMPTY;
        }
        v[8] = mine;
        mine = warp_select<9, true>(v, k, lane);
    }
    if (lane < k) {
        vals[(size_t)qi * k + lane] = mine == EMPTY ? -INFINITY : topk::key_score(mine);
        ids[(size_t)qi * k + lane] = mine == EMPTY ? -1 : (int32_t)(uint32_t)mine;
    }
}

// one CTA per query: its n keys sorted (T, the next power of two >= n)
__global__ void __launch_bounds__(SEL_NT)
rescan_select_sort(const u64* __restrict__ ws, int n, int T, int k, float* __restrict__ vals,
                   int32_t* __restrict__ ids) {
    extern __shared__ u64 keys[];
    const size_t qi = blockIdx.x;
    for (int j = threadIdx.x; j < T; j += SEL_NT) keys[j] = j < n ? ws[qi * n + j] : EMPTY;
    __syncthreads();
    topk::bitonic_sort<SEL_NT>(keys, T);
    for (int j = threadIdx.x; j < k; j += SEL_NT) {
        const u64 key = j < T ? keys[j] : EMPTY;
        const bool empty = key == EMPTY;
        vals[qi * k + j] = empty ? -INFINITY : topk::key_score(key);
        ids[qi * k + j] = empty ? -1 : (int32_t)(uint32_t)key;
    }
}

template <bool BF16>
int score_bins(const void* E, const void* q, const void* keys, int kbytes, const void* perm,
               int NW, int P, int d, int count, int kb, int bw, void* ws, cudaStream_t s) {
    constexpr int ES = BF16 ? 2 : 4;
    const int KS = (d + 15) / 16;
    const int steps = (KS + NWARPS - 1) / NWARPS;  // the widest warp slice
    int npass = 1, W = 16 * steps;
    while (W > 16 && NWARPS * warp_bytes(bw, W, ES) > SCORE_BUDGET) {
        ++npass;
        W = 16 * ((steps + npass - 1) / npass);
    }
    const size_t smem = (size_t)NWARPS * warp_bytes(bw, W, ES);
    auto kern = rescan_score<BF16>;
    cudaError_t err;
    static bool ready = false;  // the shared-memory limit, once
    if (!ready) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    // the SMs and the CTAs an SM takes at this size, asked once per size
    static int sms = 0, per_sm = 0;
    static size_t asked = 0;
    if (asked != smem) {
        int dev = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
            return (int)err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) !=
            cudaSuccess)
            return (int)err;
        asked = smem;
    }
    const int G = std::max(1, std::min((P + NW - 1) / NW, sms * std::max(per_sm, 1)));
    kern<<<G, NT, smem, s>>>((const unsigned char*)E, (const uint16_t*)q, keys, kbytes,
                             (const long long*)perm, P, NW, kb, bw, d, KS, W, count, (u64*)ws);
    return (int)cudaGetLastError();
}

int select_keys(const void* ws, int Q, int n, int k, int warp_sel, void* vals, void* ids,
           cudaStream_t s) {
    if (warp_sel) {
        rescan_select_warp<<<(Q + NWARPS - 1) / NWARPS, NT, 0, s>>>(
            (const u64*)ws, Q, n, k, (float*)vals, (int32_t*)ids);
        return (int)cudaGetLastError();
    }
    int T = 2;
    while (T < n) T <<= 1;
    static bool ready = false;
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            rescan_select_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    rescan_select_sort<<<Q, SEL_NT, (size_t)T * sizeof(u64), s>>>(
        (const u64*)ws, n, T, k, (float*)vals, (int32_t*)ids);
    return (int)cudaGetLastError();
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned;
// q_bf16 (Q, d) bf16 bits; keys (Q kb) the bin ids of the (Q, kb) lists
// sorted ascending (bins distinct per query, in [0, cap / bin_width)),
// kbytes (2, 4 or 8) bytes a key, and perm (Q kb) int64 their flat
// positions in (Q, kb) (ops/binmax_topk.py rescan_pairs), or, at Q = 1,
// the list itself (int32) and perm null; window (1 to 8) the sorted pairs
// a window (ops/binmax_topk.py pair_window); ws (Q, kb
// bin_width) uint64 keys.  stages: 1 the score launch, 2 the select
// launch, 3 both; warp_sel: the select launch by warp selection (k <= 32)
// or by a sort.  out_vals (Q, k) f32, out_ids (Q, k) int32.  d % 8 == 0,
// d <= 2048, bin_width % 16 == 0, bin_width <= 64, 1 <= kb bin_width <=
// 16384, k >= 1 (checked by the Python wrapper).  Returns the first launch
// error as a cudaError_t.
extern "C" int rescan(const void* E, int is_bf16, const void* q_bf16, const void* keys,
                      int kbytes, const void* perm, int window, int Q, int d, int count, int kb,
                      int bin_width, int k, void* ws, int stages, int warp_sel, void* out_vals,
                      void* out_ids, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (window < 1 || window > NCOL) return (int)cudaErrorInvalidValue;
    if (stages & 1) {
        const int err = is_bf16 ? score_bins<true>(E, q_bf16, keys, kbytes, perm, window,
                                                   Q * kb, d, count, kb, bin_width, ws, s)
                                : score_bins<false>(E, q_bf16, keys, kbytes, perm, window,
                                                    Q * kb, d, count, kb, bin_width, ws, s);
        if (err != 0) return err;
    }
    if (stages & 2) return select_keys(ws, Q, kb * bin_width, k, warp_sel, out_vals, out_ids, s);
    return 0;
}
