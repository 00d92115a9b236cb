// fused_topk and fused_topk_int8: single-pass top-k over f32, bf16 or
// int8 rows on Hopper.
//
// Replaces modular_rag_system_tpu/ops/fused_topk.py:_fused_kernel (via
// fused_topk_raw; f32 and bf16 rows) and :_fused_kernel_int8 (via
// fused_topk_int8_raw; int8 rows with a per-row scale).  For each query q
// it scores every live row of E as bf16(q) . bf16(E[r]) with f32
// accumulation (the TPU kernel's default precision: an f32 row is rounded
// to bf16 first, and every bf16 x bf16 product is exact in f32), or, over
// int8 rows, as (bf16(q) . float(E_q[r])) * scale[r], the dot first and
// the scale after (an int8 value is exact in bf16, so the products are
// exact there too); it never scores rows >= count, optionally reduces
// each bin of bin_width rows to its best (score, lowest row id), and
// keeps the top k by (score desc, id asc).
//
// Bound: the card must read count*d*4 (f32), *2 (bf16) or *1 (int8, plus
// 4 bytes of scale a row) bytes and do 2*Q*count*d operations.  The tiers
// send it capacities below 8192 rows, a few MB that L2 holds, so the bound
// is a few microseconds: what costs is reading the rows once per query
// (one CTA per query, as an earlier int8 design did) or on one SM, and
// sorting.
//
// Design: the grid is (row splits) x (query tiles); the launch plan in
// ops/fused_topk.py picks the query tile (QB queries, by Q and k), the
// number of splits and their rows (a multiple of 128 and of the bin
// width, so no bin straddles two splits) to put about one CTA on each SM
// at Q = 1 and at Q = 256.  A CTA keeps its QB queries as bf16 in shared
// memory (QT = 8 or 32 columns of the tensor-core tile), and walks its
// split in chunks of 128 rows: rows arrive by 16-byte cp.async copies in
// a ring of 32-deep k-steps (6 stages; 2 with 8 query columns where
// larger k's keys take the room), and each of 8 warps
// scores 16 rows x QT queries with mma.sync m16n8k16 bf16 -> f32 (an f32
// row rounded to bf16, ties to even, and an int8 row widened exactly to
// bf16, as its A fragment is formed: the ring carries the int8 bytes, a
// quarter of f32's, and the widening is a byte permute and a subtract on
// the CUDA cores).  Over int8 rows each score is multiplied by its row's
// scale as the accumulators leave the tensor cores.  The query stays bf16,
// as the TPU kernel keeps it: quantizing it for the int8 tensor cores
// would change the results.  The chunk's scores go to shared memory; a
// warp per query turns its 128
// scores into packed (score, id) keys (topk_common.cuh), takes each bin's
// minimum key by shuffles and drops the keys that cannot beat the query's
// running k-th key.  Up to k = 32 the warp selects the best k of the
// survivors and the current best in registers (each lane sorts its five,
// then k rounds of a warp minimum).  Above, a query's buffer holds its
// best KP keys (KP = next power of two >= k) and room for a chunk of
// candidates, appended by ballot; only when the room runs out, or at the
// split's end, is it sorted (bitonic, by the warp, or by the whole CTA
// when the tile is one query).  With one split the CTA writes the result; with several, each
// writes its best k keys per query to a workspace and a second kernel
// selects (k <= 32, S k <= 512) or sorts each query's S x k keys (at
// most 16,384) and keeps k.  Keys are unique, so the merge is exact.
//
// What bounds it now (PERF.md section 6): at the engine's 1,939 rows the
// device time is a few microseconds of row stream per CTA and the two
// launches; back-to-back calls are held by the wrapper's host work.  Over
// int8 rows the widening may set the pace of a k-step (measured, not
// assumed: PERF.md).

#include <cuda_bf16.h>

#include "tile_common.cuh"

namespace {

using topk::EMPTY;
using topk::key_score;
using topk::make_key;
using namespace tile;

constexpr int NT = 256;     // 8 warps
constexpr int NWARPS = NT / 32;
constexpr int CH = 128;     // rows per chunk: 8 warps x 16
constexpr int BK = 32;      // depth of a k-step
constexpr int LDE = BK + 8; // staged values per f32/bf16 row (rows padded by 16 or 32 bytes)
constexpr int SCW = CH + 4; // floats per query row of the score tile
constexpr int MERGE_NT = 512;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a CTA may use

// shared-memory bytes of a CTA (ops/fused_topk.py fused_topk_smem
// computes the same); EB is a row value's bytes: 4 (f32), 2 (bf16) or 1
// (int8)
template <int EB, int QT, int STAGES>
struct Cfg {
    static constexpr int ESIZE = EB;
    // bytes of a staged row of a k-step: padded by 16 or 32 bytes (int8:
    // by 16, which keeps every row's 16-byte copies aligned)
    static constexpr int RSTR = EB == 1 ? BK + 16 : LDE * EB;
    static constexpr int RING = STAGES * CH * RSTR;
    static size_t smem(int dpad, int QB, int T) {
        return (size_t)RING + (size_t)QT * (dpad + 8) * 2 + (size_t)QT * SCW * 4 +
               (size_t)QB * T * 8 + QT * 8 + QT * 4;
    }
};

template <int EB, int QT, int STAGES>
__global__ void __launch_bounds__(NT)
fused_topk_kernel(const void* __restrict__ Ev, const float* __restrict__ scales,
                  const uint16_t* __restrict__ qb, int Q, int d, int dpad, int count, int k,
                  int KP, int T, int bw, int QB, int R, int S, u64* __restrict__ ws,
                  float* __restrict__ out_vals, int32_t* __restrict__ out_ids) {
    using C = Cfg<EB, QT, STAGES>;
    constexpr int EPV = 16 / EB;       // values per 16-byte copy
    constexpr int CPR = BK / EPV;      // copies per row of a k-step
    constexpr int NJ = QT / 8;         // 8-query column tiles
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* ring = smem;
    const int LDQ = dpad + 8;
    uint16_t* Qs = reinterpret_cast<uint16_t*>(smem + C::RING);  // QT x LDQ bf16
    float* Sc = reinterpret_cast<float*>(Qs + QT * LDQ);          // QT x SCW
    u64* buf = reinterpret_cast<u64*>(Sc + QT * SCW);             // QB x T keys
    u64* pend = buf + (size_t)QB * T;                             // QT carried bin keys
    int* cnt = reinterpret_cast<int*>(pend + QT);                 // QT candidate counts

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
    const int rb = warp * 16;
    const int s = blockIdx.x;
    const int q0 = blockIdx.y * QB;
    const int nq = min(QB, Q - q0);
    const int rs = s * R, re = min(rs + R, count);
    const int CB = T - KP;  // candidate room of a query's buffer

    for (int i = tid; i < QB * T; i += NT) buf[i] = EMPTY;
    for (int i = tid; i < QT; i += NT) {
        pend[i] = EMPTY;
        cnt[i] = 0;
    }
    // the query tile as bf16, zero past the tile's queries and past d
    for (int i = tid; i < QT * (LDQ / 8); i += NT) {
        const int n = i / (LDQ / 8), c = (i % (LDQ / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < nq && c < d) v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + n) * d + c);
        *reinterpret_cast<uint4*>(Qs + n * LDQ + c) = v;
    }

    const int ks = dpad / BK;
    const int nchunks = re > rs ? (re - rs + CH - 1) / CH : 0;
    const int total = nchunks * ks;

    auto load = [&](int step) {
        unsigned char* slot = ring + (step % STAGES) * (CH * C::RSTR);
        const int row0 = rs + (step / ks) * CH;
        const int k0 = (step % ks) * BK;
        for (int i = tid; i < CH * CPR; i += NT) {
            const int r = i / CPR, c = (i % CPR) * EPV;
            const bool ok = row0 + r < re && k0 + c < d;
            const unsigned char* src =
                (const unsigned char*)Ev + (ok ? ((size_t)(row0 + r) * d + k0 + c) * C::ESIZE : 0);
            cp_async16(slot + r * C::RSTR + c * C::ESIZE, src, ok);
        }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < total) load(st);
        cp_async_commit();
    }

    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    for (int step = 0; step < total; ++step) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // the slot has landed for every thread, and the
                          // slot loaded next was read by all
        if (step + STAGES - 1 < total) load(step + STAGES - 1);
        cp_async_commit();

        const unsigned char* slot = ring + (step % STAGES) * (CH * C::RSTR);
        const int kq = (step % ks) * BK;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            if (EB == 2) {
                const uint16_t* As = reinterpret_cast<const uint16_t*>(slot);
                ldmatrix_x4(a, As + (rb + (mat & 1) * 8 + r8) * LDE + kk * 16 + (mat >> 1) * 8);
            } else if (EB == 1) {
                // int8 bytes (2t, 2t + 1) and (2t + 8, 2t + 9) of rows g and
                // g + 8, widened to bf16 pairs
                const unsigned char* As = slot + kk * 16 + 2 * t;
                a[0] = int8x2_bf16(*reinterpret_cast<const uint16_t*>(As + (rb + g) * C::RSTR));
                a[1] = int8x2_bf16(*reinterpret_cast<const uint16_t*>(As + (rb + g + 8) * C::RSTR));
                a[2] = int8x2_bf16(*reinterpret_cast<const uint16_t*>(As + (rb + g) * C::RSTR + 8));
                a[3] = int8x2_bf16(
                    *reinterpret_cast<const uint16_t*>(As + (rb + g + 8) * C::RSTR + 8));
            } else {
                const float* As = reinterpret_cast<const float*>(slot) + kk * 16 + 2 * t;
                const float2 x0 = *reinterpret_cast<const float2*>(As + (rb + g) * LDE);
                const float2 x1 = *reinterpret_cast<const float2*>(As + (rb + g + 8) * LDE);
                const float2 x2 = *reinterpret_cast<const float2*>(As + (rb + g) * LDE + 8);
                const float2 x3 = *reinterpret_cast<const float2*>(As + (rb + g + 8) * LDE + 8);
                a[0] = pack_bf16(x0.x, x0.y);
                a[1] = pack_bf16(x1.x, x1.y);
                a[2] = pack_bf16(x2.x, x2.y);
                a[3] = pack_bf16(x3.x, x3.y);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const uint16_t* qp = Qs + (j * 8 + g) * LDQ + kq + kk * 16 + 2 * t;
                mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(qp),
                         *reinterpret_cast<const uint32_t*>(qp + 8));
            }
        }
        if (step % ks != ks - 1) continue;

        // the chunk is scored: accumulator e of column tile j holds row
        // rb + g + 8 (e >> 1), query 8 j + 2t + (e & 1); int8 rows take
        // their scale after the dot
        const int c0 = rs + (step / ks) * CH, c1 = min(c0 + CH, re);
        if (EB == 1) {
            const int r0 = c0 + rb + g;
            const float s0 = r0 < re ? scales[r0] : 0.0f;
            const float s1 = r0 + 8 < re ? scales[r0 + 8] : 0.0f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                acc[j][0] *= s0;
                acc[j][1] *= s0;
                acc[j][2] *= s1;
                acc[j][3] *= s1;
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                Sc[(j * 8 + 2 * t + (e & 1)) * SCW + rb + g + 8 * (e >> 1)] = acc[j][e];
                acc[j][e] = 0.0f;
            }
        }
        __syncthreads();

        const bool last = step == total - 1;
        // a warp per query: keys, bin minima, the k-th-key filter, append
        for (int qq = warp; qq < nq; qq += NWARPS) {
            const float4 s4 = *reinterpret_cast<const float4*>(Sc + qq * SCW + 4 * lane);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            u64 cand[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = c0 + 4 * lane + j;
                cand[j] = r < c1 ? make_key(sv[j], r) : EMPTY;
            }
            if (bw == 2) {
                cand[0] = kmin(cand[0], cand[1]);
                cand[1] = kmin(cand[2], cand[3]);
                cand[2] = cand[3] = EMPTY;
            } else if (bw > 2) {
                u64 m = kmin(kmin(cand[0], cand[1]), kmin(cand[2], cand[3]));
                if (bw <= CH) {
                    for (int sh = 1; 4 * sh < bw; sh <<= 1) m = kmin(m, __shfl_xor_sync(0xffffffffu, m, sh));
                    if (lane % (bw / 4)) m = EMPTY;
                } else {
                    // a bin of several chunks: its running minimum is
                    // carried and emitted at the bin's last chunk
#pragma unroll
                    for (int sh = 1; sh < 32; sh <<= 1) m = kmin(m, __shfl_xor_sync(0xffffffffu, m, sh));
                    if (lane == 0) {
                        m = kmin(m, pend[qq]);
                        if (c1 % bw == 0 || c1 == re) {
                            pend[qq] = EMPTY;
                        } else {
                            pend[qq] = m;
                            m = EMPTY;
                        }
                    } else {
                        m = EMPTY;
                    }
                }
                cand[0] = m;
                cand[1] = cand[2] = cand[3] = EMPTY;
            }
            u64* kq_buf = buf + (size_t)qq * T;
            const u64 kth = kq_buf[k - 1];
            if (KP <= 32) {
                // small k: the best k of the survivors and the current best
                // by a warp selection, no candidate buffer (T = KP)
                bool any = false;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (!(cand[j] < kth)) cand[j] = EMPTY;
                    any |= cand[j] != EMPTY;
                }
                if (!__any_sync(0xffffffffu, any)) continue;
                u64 v[5] = {cand[0], cand[1], cand[2], cand[3], lane < k ? kq_buf[lane] : EMPTY};
                __syncwarp();
                const u64 mine = warp_select<5>(v, k, lane);
                if (lane < k) kq_buf[lane] = mine;
                __syncwarp();
                continue;
            }
            int n = cnt[qq];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool pass = cand[j] < kth;
                const unsigned ball = __ballot_sync(0xffffffffu, pass);
                if (pass) kq_buf[KP + n + __popc(ball & ((1u << lane) - 1))] = cand[j];
                n += __popc(ball);
            }
            __syncwarp();
            // sort when another chunk's candidates might not fit, and at
            // the split's end; keep the best KP
            if (QB > 1 && n > 0 && (n + CH > CB || last)) {
                warp_sort(kq_buf, T, lane);
                for (int i = KP + lane; i < T; i += 32) kq_buf[i] = EMPTY;
                n = 0;
                __syncwarp();
            }
            if (lane == 0) cnt[qq] = n;
        }
        __syncthreads();
        if (QB == 1 && cnt[0] > 0 && (cnt[0] + CH > CB || last)) {
            topk::bitonic_sort<NT>(buf, T);  // ends with a barrier
            for (int i = KP + tid; i < T; i += NT) buf[i] = EMPTY;
            __syncthreads();
            if (tid == 0) cnt[0] = 0;
        }
        // the keys and counts are read again only after the next chunk's
        // barriers
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int o = tid; o < nq * k; o += NT) {
        const int qq = o / k, j = o % k;
        const u64 key = buf[(size_t)qq * T + j];
        const size_t qi = (size_t)(q0 + qq);
        if (S > 1) {
            ws[(qi * S + s) * k + j] = key;
        } else {
            out_vals[qi * k + j] = key == EMPTY ? -INFINITY : key_score(key);
            out_ids[qi * k + j] = key == EMPTY ? 0x7FFFFFFF : (int32_t)(uint32_t)key;
        }
    }
}

// the best k (k <= 32) of one query's n <= 32 N merge keys, by the first
// warp
template <int N>
__device__ __forceinline__ void merge_select(const u64* __restrict__ w, int n, int k,
                                             float* __restrict__ vals, int32_t* __restrict__ ids) {
    const int lane = threadIdx.x;
    u64 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = lane + 32 * i < n ? w[lane + 32 * i] : EMPTY;
    const u64 key = warp_select<N>(v, k, lane);
    if (lane < k) {
        vals[lane] = key == EMPTY ? -INFINITY : key_score(key);
        ids[lane] = key == EMPTY ? 0x7FFFFFFF : (int32_t)(uint32_t)key;
    }
}

// each query's S sorted lists of k keys -> its best k: a warp selection
// (k <= 32, S k <= 512) or one sort of M (a power of two >= S k) keys in
// shared memory
__global__ void __launch_bounds__(MERGE_NT)
fused_topk_merge_kernel(const u64* __restrict__ ws, int S, int k, int M,
                        float* __restrict__ out_vals, int32_t* __restrict__ out_ids) {
    extern __shared__ u64 keys[];
    const size_t qi = blockIdx.x;
    const int n = S * k;
    if (k <= 32 && n <= 512) {
        // a warp selection over at most 8 (or 16) keys a lane
        if (threadIdx.x < 32) {
            if (n <= 256) merge_select<8>(ws + qi * n, n, k, out_vals + qi * k, out_ids + qi * k);
            else merge_select<16>(ws + qi * n, n, k, out_vals + qi * k, out_ids + qi * k);
        }
        return;
    }
    for (int i = threadIdx.x; i < M; i += MERGE_NT) keys[i] = i < n ? ws[qi * n + i] : EMPTY;
    __syncthreads();
    topk::bitonic_sort<MERGE_NT>(keys, M);
    for (int j = threadIdx.x; j < k; j += MERGE_NT) {
        const u64 key = keys[j];
        out_vals[qi * k + j] = key == EMPTY ? -INFINITY : key_score(key);
        out_ids[qi * k + j] = key == EMPTY ? 0x7FFFFFFF : (int32_t)(uint32_t)key;
    }
}

template <int EB, int QT, int STAGES>
int launch(const void* E, const float* scales, const void* q, int Q, int d, int count, int k,
           int bw, int QB, int S, int R, void* ws, void* vals, void* ids, cudaStream_t stream) {
    using C = Cfg<EB, QT, STAGES>;
    int KP = 1;
    while (KP < k) KP <<= 1;
    const int T = KP <= 32 ? KP : (KP >= CH ? 2 * KP : 2 * CH);
    const int dpad = (d + BK - 1) / BK * BK;
    const size_t smem = C::smem(dpad, QB, T);
    auto kern = fused_topk_kernel<EB, QT, STAGES>;
    cudaError_t err;
    static bool ready = false;  // both kernels' shared-memory limits, once
    if (!ready) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(fused_topk_merge_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    const dim3 grid(S, (Q + QB - 1) / QB);
    kern<<<grid, NT, smem, stream>>>(E, scales, (const uint16_t*)q, Q, d, dpad, count, k, KP, T,
                                     bw, QB, R, S, (u64*)ws, (float*)vals, (int32_t*)ids);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return (int)err;
    int M = 1;
    while (M < S * k) M <<= 1;
    const size_t msmem = k <= 32 && S * k <= 512 ? 0 : (size_t)M * sizeof(u64);
    fused_topk_merge_kernel<<<Q, MERGE_NT, msmem, stream>>>((const u64*)ws, S, k, M,
                                                            (float*)vals, (int32_t*)ids);
    return (int)cudaGetLastError();
}

template <int EB>
int dispatch(int cfg, const void* E, const float* sc, const void* q, int Q, int d, int count,
             int k, int bw, int QB, int S, int R, void* ws, void* vals, void* ids,
             cudaStream_t s) {
    switch (cfg) {
        case 0: return launch<EB, 8, 6>(E, sc, q, Q, d, count, k, bw, QB, S, R, ws, vals, ids, s);
        case 1: return launch<EB, 8, 2>(E, sc, q, Q, d, count, k, bw, QB, S, R, ws, vals, ids, s);
        case 2: return launch<EB, 32, 6>(E, sc, q, Q, d, count, k, bw, QB, S, R, ws, vals, ids, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), q_bf16 (Q, d) bf16
// bits (16-byte aligned), out_vals (Q, k) f32, out_ids (Q, k) int32; count
// <= cap.  The launch plan (ops/fused_topk.py fused_topk_plan): cfg 0 (8
// query columns, 6 ring stages), 1 (8, 2) or 2 (32, 6), QB
// queries a CTA, S splits of R rows (R a multiple of 128 and of the bin
// width); ws (Q, S, k) int64 when S > 1.  d % 8 == 0, d <= 2048,
// 1 <= k <= 8192, S k <= 16384, bin_width dividing 128 or a multiple of
// it (checked by the Python wrapper).  Slots with no candidate hold
// (-inf, INT32_MAX).  Returns the first failing launch's cudaError_t.
extern "C" int fused_topk(const void* E, int is_bf16, const void* q_bf16, int Q, int d,
                          int count, int k, int bin_width, int cfg, int QB, int S, int R,
                          void* ws, void* out_vals, void* out_ids, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return dispatch<2>(cfg, E, nullptr, q_bf16, Q, d, count, k, bin_width, QB, S, R, ws,
                           out_vals, out_ids, s);
    return dispatch<4>(cfg, E, nullptr, q_bf16, Q, d, count, k, bin_width, QB, S, R, ws,
                       out_vals, out_ids, s);
}

// The int8 row type: E_q (cap, d) int8 (16-byte aligned, d % 16 == 0),
// scales (cap,) f32; every other argument as fused_topk's, the plan for a
// row of d bytes.
extern "C" int fused_topk_int8(const void* E_q, const void* scales, const void* q_bf16, int Q,
                               int d, int count, int k, int bin_width, int cfg, int QB, int S,
                               int R, void* ws, void* out_vals, void* out_ids, void* stream) {
    return dispatch<1>(cfg, E_q, (const float*)scales, q_bf16, Q, d, count, k, bin_width, QB,
                       S, R, ws, out_vals, out_ids, (cudaStream_t)stream);
}
