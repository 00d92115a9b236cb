// fine_topk: the ivf fine stage's selecting kernel on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_kernel (via fine_call).
// For query i it scores the rows of its candidate slabs blk/vcnt (Q, L) as
// bf16(q) . row summed in f32 (int8 and int4 rows times their scale after
// the dot; rows at or past the pair's vcnt never score) and keeps the top k
// by (score desc, slot asc), slot = blk * 256 + row: vals (Q, k) f32 and
// slots (Q, k) int32, -1 where fewer than k rows scored.  The engine
// reaches it at deep nprobe, when the score dump would pass its buffer
// limits (never with an int4 copy, whose per-slot bias needs the dump;
// that mode is for direct callers).
//
// Bound: memory, the live rows of the probed slabs once each; the output
// is tiny.  A design that walks each query's list on its own CTAs reads
// a slab once per query that probes it: at nprobe 512 and Q = 16,
// 73,728 slab reads for 16,210 distinct slabs, at the memory's rate.  The
// only gain left is to read fewer bytes.
//
// Design: a slab is read once per query tile and scored against every
// query of the tile that probes it.  The wrapper (ops/ivf2.py fine_call)
// sorts the live (query, slot) pairs by (query tile, block) on the device:
// key = tile * (nblocks + 1) + blk, dead slots (vcnt <= 0) keyed past every
// block of their tile, so they load nothing and never mask a live block 0.
// A work item is a run of equal keys: one block and the pairs of the tile
// that list it, each with its own vcnt (a slot listed twice is two pairs
// and scores twice, as in the plain version).  The grid is G x (query
// tiles); CTA g of a tile finds the tile's live pairs by a binary search
// of the sorted keys and takes the items that start in its g-th share.
// It keeps the tile's QB queries as bf16 in shared memory and streams each
// item's slab through a ring of k-steps that runs on across items: a k-step
// is one TMA box, the slab's stored rows x 64 bytes (32 bf16 or 64 int8 or
// packed int4 values) in the 64-byte swizzle, issued by one thread and
// signalled on the slot's mbarrier (the same ring filled by per-thread
// cp.async copies was markedly slower: PERF.md section 6); 8 warps
// score the slab's 256 logical rows x 8 pairs at a time with mma.sync
// m16n8k16 bf16 -> f32 (int8 and int4 values widened exactly to bf16 as
// the A fragments are formed; in the int4 copy a stored row's high and low
// nibbles are logical rows r and r + 128, two A tiles of one load), the
// column of a pair reading its query's row of the tile; a second product
// of the same fragments with their sign bits cleared gives each score's
// sum of |q_i x_i|.  Both go to shared memory with the scale applied.
//
// The selection returns fine_scores' own values, so that the dump path
// and this kernel pick the same slots, ties and near-ties included (the
// JAX package's invariant).  The tensor cores sum in another order than
// fine_scores' lanes, so a tensor-core score s only bounds the row's
// fine_scores score: within e = 2^-14 sum |q_i x_i| (both sums round far
// less at d <= 1024).  A warp per query (the tile's queries dealt
// round-robin to the warps) takes each of its columns, masked by that
// pair's vcnt; a row with s + e below the running k-th key's score (or,
// before k keys exist, below the column's k-th best s - e) cannot enter
// the top k; the others, a few a column once the k-th key has risen, are
// listed, and scored again NB at a time with fine_scores' arithmetic
// (fine_common.cuh's per-vector dots and butterfly, the rows from L2, the
// query as f32, the scale after the dot), and their (score, slot) keys
// (topk_common.cuh) selected: up to k = 32 inserted into the sorted best
// k, above appended to a buffer of the best KP keys and room for
// candidates, sorted when the room runs out.  With one CTA per tile it
// writes the result; with G, each writes its k keys per query and a merge
// launch sorts each query's G k keys.
//
// The ring's TMA boxes, the k-step's fragments and products and the exact
// rescore are fine_tile.cuh's, shared with fine_binmax.cu.
//
// Shared memory: ring (STAGES x stored rows x 64 bytes, and its
// mbarriers) + query tile (QB x (dpad + 8) bf16) + scores and their
// bounds (2 x COLS x 260 f32) + each warp's f32 query and survivor list
// (8 x (dpad + 256) x 4) + keys (QB x T x 8) + per-query counts and the
// group's column table; ops/ivf2.py fine_topk_smem computes the same.
//
// What bounds it now (PERF.md section 6): at nprobe 512 about twice the
// unique slabs' bytes; a block barrier and an mbarrier wait every 16 KB
// step, and the selection; a query tile's first rows in every CTA are
// rescored exactly, which dominates where items hold few pairs (the int4
// direct call).

#include "fine_tile.cuh"

namespace {

using topk::EMPTY;
using namespace tile;
using namespace ftile;

constexpr int NT = 256;      // 8 warps
constexpr int NWARPS = NT / 32;
constexpr int KALIGN = 64;   // d is padded to a multiple of the deepest k-step
constexpr int SL = fine::SLAB;
constexpr int SCW = SL + 4;  // floats per column of the score tile
constexpr int COLS = 8;       // pairs the tensor-core tile scores at a time
constexpr int MERGE_NT = 512;
constexpr int SMEM_MAX = 232448;

template <int MODE, int STAGES>
struct Cfg {
    static constexpr int SR = fine::stored_slab<MODE>();  // stored rows a slab
    // a k-step: 32 bf16 or 64 int8 / packed int4 values, 64 bytes of each
    // stored row
    static constexpr int BKV = kstep_values<MODE>();
    static constexpr int SLOT = slot_bytes<MODE>();  // a TMA box, 8 or 16 KB
    static size_t smem(int dpad, int QB, int T) {
        return (size_t)STAGES * (SLOT + 16) + (size_t)QB * (dpad + 8) * 2 +
               (size_t)2 * COLS * SCW * 4 + (size_t)NWARPS * (dpad + SL) * 4 +
               (size_t)QB * T * 8 + (size_t)QB * 4 + (size_t)COLS * 8;
    }
};

// first index of the sorted keys[0, P) that is >= x
__device__ __forceinline__ int lower_bound(const long long* __restrict__ keys, int P,
                                           long long x) {
    int lo = 0, hi = P;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// an item: the run of equal keys that starts at pair p0 (np pairs) and
// its block; steps = its k-steps in all
struct Item {
    int p0, np, blk, steps;
};

__device__ __forceinline__ Item fetch_item(const long long* __restrict__ keys, int p0, int hi,
                                           long long base, int ks, int cols) {
    Item it;
    it.p0 = p0;
    const long long key = keys[p0];
    it.blk = (int)(key - base);
    int p = p0;
    for (;;) {  // four keys' loads in flight at a time
        long long kq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kq[i] = p + i < hi ? keys[p + i] : -1;
        int i = 0;  // the run's keys among the four (unrolled: kq stays in registers)
#pragma unroll
        for (int j = 0; j < 4; ++j) i += i == j && kq[j] == key;
        p += i;
        if (i < 4) break;
    }
    it.np = p - p0;
    it.steps = (it.np + cols - 1) / cols * ks;
    return it;
}

__device__ __forceinline__ int warp_of_thread() { return threadIdx.x >> 5; }

// survivors rescored together
constexpr int NB = 2;

template <int MODE, int STAGES>
__global__ void __launch_bounds__(NT, 1)
fine_topk_kernel(const __grid_constant__ CUtensorMap tmap, const unsigned char* __restrict__ E,
                 const float* __restrict__ scales3,
                 const uint16_t* __restrict__ qb, const long long* __restrict__ keys,
                 const long long* __restrict__ perm, const int32_t* __restrict__ pvc, int P,
                 int L, int nb, int Q, int d, int dpad, int k, int KP, int T, int QB, int G,
                 u64* __restrict__ part, float* __restrict__ out_vals,
                 int32_t* __restrict__ out_slots) {
    using C = Cfg<MODE, STAGES>;
    constexpr int NJ = COLS / 8;
    extern __shared__ __align__(128) unsigned char smem[];
    const int LDQ = dpad + 8;
    unsigned char* ring = smem;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + STAGES * C::SLOT);  // STAGES
    uint16_t* Qs = reinterpret_cast<uint16_t*>(bar + 2 * STAGES);          // QB x LDQ
    float* Sc = reinterpret_cast<float*>(Qs + (size_t)QB * LDQ);           // COLS x SCW
    float* Sa = Sc + COLS * SCW;                                           // COLS x SCW
    float* qw = Sa + COLS * SCW + warp_of_thread() * dpad;                 // the warp's query
    int* slist = reinterpret_cast<int*>(Sa + COLS * SCW + NWARPS * dpad) +
                 warp_of_thread() * SL;                                    // the warp's survivors
    u64* buf = reinterpret_cast<u64*>(Sa + COLS * SCW + NWARPS * dpad + NWARPS * SL);  // QB x T
    int* cnt = reinterpret_cast<int*>(buf + (size_t)QB * T);               // QB
    int* gq = cnt + QB;                                                    // COLS
    int* gv = gq + COLS;                                                   // COLS

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int cg = blockIdx.x, tile = blockIdx.y;
    const int q0 = tile * QB, nq = min(QB, Q - q0);
    const int CB = T - KP;

    // this tile's live pairs, and the share of them whose items this CTA takes
    const long long base = (long long)tile * (nb + 1);
    const int lo = lower_bound(keys, P, base), hi = lower_bound(keys, P, base + nb);
    const int n = hi - lo;
    int plo = lo + (int)((long long)n * cg / G);
    const int phi = lo + (int)((long long)n * (cg + 1) / G);
    while (plo < phi && plo > lo && keys[plo] == keys[plo - 1]) ++plo;  // an item's start

    for (int i = tid; i < QB * T; i += NT) buf[i] = EMPTY;
    for (int i = tid; i < QB; i += NT) cnt[i] = 0;
    for (int i = tid; i < QB * (LDQ / 8); i += NT) {
        const int r = i / (LDQ / 8), c = (i % (LDQ / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < nq && c < d) v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * d + c);
        *reinterpret_cast<uint4*>(Qs + (size_t)r * LDQ + c) = v;
    }

    const int ks = dpad / C::BKV;
    // the loader's and the consumer's item cursors walk the same items:
    // the item, the k-step within its group, the steps left in the item
    Item li{plo, 0, 0, 0}, ci{plo, 0, 0, 0};
    if (plo < phi) {
        li = fetch_item(keys, plo, hi, base, ks, COLS);
        ci = li;
    }
    int lkk = 0, lrem = li.steps, ckk = 0, cgrp = 0, crem = ci.steps;
    if (tid == 0) {
        for (int st = 0; st < STAGES; ++st) mbar_init(bar + st);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a k-step of a slab: one TMA box into the step's ring slot, issued by
    // one thread (the slot's last readers passed the barrier before)
    auto load = [&](int step) {
        if (li.p0 >= phi) return;
        if (tid == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            tma_box(ring + (step % STAGES) * C::SLOT, &tmap, lkk * C::BKV, li.blk * C::SR,
                    bar + step % STAGES, C::SLOT);
        }
        if (++lkk == ks) lkk = 0;
        if (--lrem == 0) {
            const int nxt = li.p0 + li.np;
            li = nxt < phi ? fetch_item(keys, nxt, hi, base, ks, COLS)
                           : Item{nxt, 0, 0, 0};
            lrem = li.steps;
        }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) load(st);

    // the tensor cores' scores and, from the values' magnitudes, their sums
    // of |q_i x_i|, which bound how far a score may be from fine_scores'
    float acc[2][NJ][4], acc_abs[2][NJ][4];
    int cq[NJ];  // the local query of each of the thread's columns (-1: none)
    int wq = -1;  // the query in the warp's f32 copy
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        cq[j] = -1;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = acc_abs[m][j][e] = 0.0f;
    }
    for (int step = 0; ci.p0 < phi; ++step) {
        mbar_wait(bar + step % STAGES, (step / STAGES) & 1);
        __syncthreads();  // the slot has landed for every thread, and the
                          // slot loaded next was read by all
        load(step + STAGES - 1);

        const int kstep = ckk;
        const int pg = ci.p0 + cgrp * COLS;  // the group's first pair
        if (kstep == 0) {
            // the group's columns: the local query of each pair (-1: none)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int p = pg + j * 8 + g;
                cq[j] = p < ci.p0 + ci.np ? (int)(perm[p] / L) - q0 : -1;
            }
        }
        score_kstep<MODE, NJ>(ring + (step % STAGES) * C::SLOT, Qs, LDQ, cq, kstep * C::BKV,
                              warp, lane, acc, acc_abs);
        if (kstep == ks - 1) {
            // the group is scored: accumulator e of A tile m, column tile j
            // holds logical row lr(m, g + 8 (e >> 1)), column 8 j + 2t + (e & 1)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int lr = acc_row<MODE>(warp, m, g, h);
                    const float s =
                        MODE == fine::BF16 ? 1.0f : scales3[(size_t)ci.blk * SL + lr];
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float v = acc[m][j][2 * h + e], va = acc_abs[m][j][2 * h + e];
                            Sc[(j * 8 + 2 * t + e) * SCW + lr] = MODE == fine::BF16 ? v : v * s;
                            Sa[(j * 8 + 2 * t + e) * SCW + lr] = MODE == fine::BF16 ? va : va * s;
                            // zeroed for the next group here: nothing is
                            // live in them across the selection
                            acc[m][j][2 * h + e] = acc_abs[m][j][2 * h + e] = 0.0f;
                        }
                }
            if (tid < COLS) {
                const int p = pg + tid;
                const bool in = p < ci.p0 + ci.np;
                gq[tid] = in ? (int)(perm[p] / L) - q0 : -1;
                gv[tid] = in ? min(pvc[p], SL) : 0;
            }
            __syncthreads();

            // a warp per query.  A row can enter the query's top k only if
            // its fine_scores score can beat the running k-th key; the
            // tensor cores' score s is within e = 2^-14 sum |q_i x_i| of it
            // (both sums' rounding is far smaller), so the rows with
            // s + e >= theta, theta the k-th key's score (or, before k keys
            // exist, the column's k-th best s - e), are scored again with
            // fine_scores' own arithmetic and selected by that score:
            // every value and tie the dump path sees, bit for bit.
            const int slot0 = ci.blk * SL;
            const uint4* slab = reinterpret_cast<const uint4*>(E) +
                                (size_t)ci.blk * C::SR * fine::row_vectors<MODE>(d);
            for (int c = 0; c < COLS; ++c) {
                const int lq = gq[c];
                if (lq < 0 || lq % NWARPS != warp) continue;
                const int vc = gv[c];
                if (lq != wq) {  // the query as f32, fine_scores' operand
                    for (int j = lane; j < d; j += 32)
                        qw[j] = __uint_as_float((uint32_t)Qs[(size_t)lq * LDQ + j] << 16);
                    wq = lq;
                    __syncwarp();
                }
                float sv[8], ev[8];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float4 x = *reinterpret_cast<const float4*>(Sc + c * SCW + 8 * lane + 4 * h);
                    const float4 y = *reinterpret_cast<const float4*>(Sa + c * SCW + 8 * lane + 4 * h);
                    sv[4 * h] = x.x, sv[4 * h + 1] = x.y, sv[4 * h + 2] = x.z, sv[4 * h + 3] = x.w;
                    ev[4 * h] = y.x, ev[4 * h + 1] = y.y, ev[4 * h + 2] = y.z, ev[4 * h + 3] = y.w;
                }
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) ev[jj] *= ERR;
                u64* kb = buf + (size_t)lq * T;
                u64 kth = kb[k - 1];
                float theta = kth == EMPTY ? -INFINITY : topk::key_score(kth);
                if (KP <= 32 && kth == EMPTY) {
                    // k rows score at least the column's k-th best s - e
                    u64 lb[8];
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj)
                        lb[jj] = 8 * lane + jj < vc
                                     ? topk::make_key(sv[jj] - ev[jj], slot0 + 8 * lane + jj)
                                     : EMPTY;
                    const u64 kl = __shfl_sync(0xffffffffu, warp_select<8, true>(lb, k, lane),
                                               k - 1);
                    if (kl != EMPTY) theta = topk::key_score(kl);
                }
                // the rows that might beat the k-th key, listed
                int ns = 0;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const bool in = 8 * lane + jj < vc && sv[jj] + ev[jj] >= theta;
                    const unsigned ball = __ballot_sync(0xffffffffu, in);
                    if (in) slist[ns + __popc(ball & ((1u << lane) - 1))] = 8 * lane + jj;
                    ns += __popc(ball);
                }
                __syncwarp();
                int nc = cnt[lq];
                for (int b = 0; b < ns;) {
                    // the next NB rows that can still beat it, scored together
                    int rows[NB], sp[NB];
#pragma unroll
                    for (int u = 0; u < NB; ++u) {
                        while (b < ns && Sc[c * SCW + slist[b]] + ERR * Sa[c * SCW + slist[b]] < theta)
                            ++b;
                        rows[u] = b < ns ? slist[b++] : -1;
                        sp[u] = rows[u] < 0 ? -1 : (MODE == fine::INT4 ? rows[u] % (SL / 2) : rows[u]);
                    }
                    float dh[NB], dl[NB];
                    score_any_rows<MODE, NB>(slab, fine::row_vectors<MODE>(d), sp, qw, lane, dh, dl);
#pragma unroll
                    for (int u = 0; u < NB; ++u) {
                        const int row = rows[u];
                        if (row < 0) continue;
                        float a = MODE == fine::INT4 && row >= SL / 2 ? dl[u] : dh[u];
                        if (MODE != fine::BF16) a = a * scales3[(size_t)ci.blk * SL + row];
                        const u64 key = topk::make_key(a, slot0 + row);
                        if (!(key < kth)) continue;
                        if (KP <= 32) {
                            // insert into the sorted best k (a copy after its equals)
                            const u64 mine = lane < k ? kb[lane] : EMPTY;
                            const int pos =
                                __popc(__ballot_sync(0xffffffffu, lane < k && mine <= key));
                            const u64 up = __shfl_up_sync(0xffffffffu, mine, 1);
                            const u64 nv = lane < pos ? mine : (lane == pos ? key : up);
                            __syncwarp();
                            if (lane < k) kb[lane] = nv;
                            kth = __shfl_sync(0xffffffffu, nv, k - 1);
                            __syncwarp();
                        } else {
                            if (lane == 0) kb[KP + nc] = key;
                            __syncwarp();
                            if (++nc == CB) {  // the room is full: keep the best KP
                                warp_sort(kb, T, lane);
                                for (int i = KP + lane; i < T; i += 32) kb[i] = EMPTY;
                                nc = 0;
                                kth = kb[k - 1];
                                __syncwarp();
                            }
                        }
                        if (kth != EMPTY) theta = fmaxf(theta, topk::key_score(kth));
                    }
                }
                if (KP > 32 && lane == 0) cnt[lq] = nc;
                __syncwarp();
            }
            // the keys, counts and column table are read again only after
            // the next step's barrier
        }
        if (++ckk == ks) {
            ckk = 0;
            ++cgrp;
        }
        if (--crem == 0) {
            const int nxt = ci.p0 + ci.np;
            // the loader, a few steps ahead, has fetched it already
            ci = li.p0 == nxt ? li
                              : nxt < phi ? fetch_item(keys, nxt, hi, base, ks, COLS)
                                          : Item{nxt, 0, 0, 0};
            cgrp = 0;
            crem = ci.steps;
        }
    }
    __syncthreads();
    // the candidates left in the buffers
    if (KP > 32) {
        for (int lq = warp; lq < nq; lq += NWARPS) {
            if (cnt[lq] == 0) continue;
            u64* kb = buf + (size_t)lq * T;
            warp_sort(kb, T, lane);
        }
        __syncthreads();
    }

    for (int o = tid; o < nq * k; o += NT) {
        const int lq = o / k, j = o % k;
        const u64 key = buf[(size_t)lq * T + j];
        const size_t qi = (size_t)(q0 + lq);
        if (G > 1) {
            part[(qi * G + cg) * k + j] = key;
        } else {
            out_vals[qi * k + j] = key == EMPTY ? -INFINITY : topk::key_score(key);
            out_slots[qi * k + j] = key == EMPTY ? -1 : (int32_t)(uint32_t)key;
        }
    }
}

// one CTA per query: the best k of its G sorted partial lists
__global__ void __launch_bounds__(MERGE_NT)
fine_topk_merge(const u64* __restrict__ part, int G, int k, int T2,
                float* __restrict__ vals, int32_t* __restrict__ slots) {
    extern __shared__ u64 mkeys[];
    const size_t i = blockIdx.x;
    const int n = G * k;
    for (int x = threadIdx.x; x < T2; x += MERGE_NT) mkeys[x] = x < n ? part[i * n + x] : EMPTY;
    __syncthreads();
    topk::bitonic_sort<MERGE_NT>(mkeys, T2);
    for (int t = threadIdx.x; t < k; t += MERGE_NT) {
        const u64 key = mkeys[t];
        const bool empty = key == EMPTY;
        vals[i * k + t] = empty ? -INFINITY : topk::key_score(key);
        slots[i * k + t] = empty ? -1 : (int32_t)(uint32_t)key;
    }
}

template <int MODE, int STAGES>
int launch(const void* E, const void* sc, const void* q, const void* keys, const void* perm,
           const void* pvc, int P, int L, int nb, int Q, int d, int k, int QB, int G,
           void* part, void* vals, void* slots, cudaStream_t s) {
    using C = Cfg<MODE, STAGES>;
    CUtensorMap tmap;
    const int merr = slab_map<MODE>(&tmap, E, nb, d);
    if (merr != 0) return merr;
    int KP = 1;
    while (KP < k) KP <<= 1;
    const int T = KP <= 32 ? KP : (2 * KP > 512 ? 2 * KP : 512);
    const int dpad = (d + KALIGN - 1) / KALIGN * KALIGN;
    auto kern = fine_topk_kernel<MODE, STAGES>;
    cudaError_t err;
    static bool ready = false;  // both kernels' shared-memory limits, once
    if (!ready) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(fine_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    const dim3 grid(G, (Q + QB - 1) / QB);
    kern<<<grid, NT, C::smem(dpad, QB, T), s>>>(
        tmap, (const unsigned char*)E, (const float*)sc, (const uint16_t*)q, (const long long*)keys,
        (const long long*)perm, (const int32_t*)pvc, P, L, nb, Q, d, dpad, k, KP, T, QB, G,
        (u64*)part, (float*)vals, (int32_t*)slots);
    if ((err = cudaGetLastError()) != cudaSuccess || G == 1) return (int)err;
    int T2 = 1;
    while (T2 < G * k) T2 <<= 1;
    fine_topk_merge<<<Q, MERGE_NT, (size_t)T2 * 8, s>>>((const u64*)part, G, k, T2, (float*)vals,
                                                        (int32_t*)slots);
    return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(int cfg, const void* E, const void* sc, const void* q, const void* keys,
             const void* perm, const void* pvc, int P, int L, int nb, int Q, int d, int k,
             int QB, int G, void* part, void* vals, void* slots, cudaStream_t s) {
    switch (cfg) {
        case 0:
            return launch<MODE, 6>(E, sc, q, keys, perm, pvc, P, L, nb, Q, d, k, QB, G, part,
                                      vals, slots, s);
        case 1:
            return launch<MODE, 2>(E, sc, q, keys, perm, pvc, P, L, nb, Q, d, k, QB, G, part,
                                      vals, slots, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128,
// d) packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused
// for bf16), q_bf16 (Q, d) bf16 bits (16-byte aligned); keys (P = Q L)
// int64 sorted ascending, perm (P) int64 their pairs' flat positions in
// the (Q, L) lists and pvc (P) int32 their vcnt: key = (i / QB) (nblocks
// + 1) + blk[i, j], or + nblocks where vcnt[i, j] <= 0 (ops/ivf2.py
// fine_pair_keys).  The plan
// (ops/ivf2.py fine_topk_plan): cfg 0 (6 ring stages) or 1 (2), QB
// queries a tile, G CTAs a tile; part (Q, G, k)
// uint64 scratch when G > 1; vals (Q, k) f32, slots (Q, k) int32.
// d % 16 == 0, d <= 1024, 1 <= k <= 8192, G next_pow2(k) <= 4096 or G = 1,
// Q <= 65535 (checked by the Python wrapper).  Returns the first launch
// error as a cudaError_t.
extern "C" int fine_topk(const void* E_c3, int mode, const void* scales3, const void* q_bf16,
                         const void* keys, const void* perm, const void* pvc, int P, int L,
                         int nblocks, int Q, int d, int k, int cfg, int QB, int G, void* part,
                         void* vals, void* slots, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (mode == fine::INT4)
        return dispatch<fine::INT4>(cfg, E_c3, scales3, q_bf16, keys, perm, pvc, P, L, nblocks,
                                    Q, d, k, QB, G, part, vals, slots, s);
    if (mode == fine::INT8)
        return dispatch<fine::INT8>(cfg, E_c3, scales3, q_bf16, keys, perm, pvc, P, L, nblocks,
                                    Q, d, k, QB, G, part, vals, slots, s);
    return dispatch<fine::BF16>(cfg, E_c3, scales3, q_bf16, keys, perm, pvc, P, L, nblocks, Q,
                                d, k, QB, G, part, vals, slots, s);
}
