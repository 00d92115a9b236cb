// fine_binmax: the maxima probe of the ivf fine stage on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_binmax_kernel (via
// _fine_binmax_call).  For query i and its candidate block list blk/vcnt
// (Q, L) it writes
//
//     out[i, j] = max over r < vcnt[i, j] of
//                 bf16(q_i) . E_c3[blk[i, j], r]  (x scales3[blk, r] for int8, int4)
//
// and -inf for a dead slot (vcnt 0), as (Q, L) f32, bit-equal to the row
// maximum of fine_scores' dump (the JAX package's invariant: all three fine
// kernels score a row with the same arithmetic).  It is the streaming
// floor beside which fine_scores and fine_topk are read; it is on no
// serving path.
//
// Bound: memory, the live rows of the probed slabs once each.  A design
// that gives each (query, slot) pair its own CTA reads a slab once per
// query that lists it (20,161 pairs for 8,455 slabs at the smoke's int8
// lists), and its CUDA-core dots, not memory, set its pace.
//
// Design: fine_topk.cu's slab scoring with a per-pair maximum in place of
// the selection.  The wrapper (ops/ivf2.py fine_binmax_call) sorts the
// pairs by block on the device (dead slots keyed past every block, so they
// come last); at Q = 1, where no two pairs share a block, the pairs stay in
// list order with no sort.  A persistent grid takes windows of W pairs (up
// to 8 sorted, pair_window; 1 in list order), CTA b the windows b, b + G,
// ...; a run is a window's pairs
// that share a block, found by one warp-wide load of the window's keys and
// a ballot, so a slab is read once for each run that lists it: at most the
// unique slabs + one a window.  Each run's slab streams through
// fine_tile.cuh's TMA ring of k-steps, which runs on across runs, and the 8
// warps score its 256 logical rows x the run's pairs on mma.sync m16n8k16
// (the queries as bf16 columns), with each score's sum of |q_i x_i| beside
// it.  Warp 0 also keeps the ring's cursor: on reaching a run it writes
// the run's descriptor (pairs, block, vcnt) to shared memory and starts
// the copies of its queries into one of two query tiles, a run ahead of
// the consumers, so no warp waits on a dependent global load at a run's
// start; the lookahead stays within a run's k-steps so a tile is never
// loaded while its run is still read.  Shared memory holds two CTAs an SM.
//
// What bounds it (PERF.md section 6): the scoring of each k-step
// (the widening of int8 and int4 values to bf16 as the fragments are
// formed, then the mma.sync instructions), not the slab stream.
//
// The certificate: a tensor-core score s_r is within e_r = 2^-14 sum
// |q_i x_i| (x scale) of fine_scores' score x_r, so with M = max over live
// rows of s_r - e_r, the row that holds the true maximum has s_r + e_r >=
// x_r >= M.  A warp per pair lists those candidate rows and scores them
// again with fine_scores' arithmetic (fine_common.cuh's dot_rows, the query
// as f32, the rows from L2, the scale after the dot); their maximum is
// written.  No tensor-core score is ever written.
//
// Shared memory: ring (STAGES x stored rows x 64 bytes, and its
// mbarriers) + two run descriptors + two query tiles (2 x COLS x (dpad + 8)
// bf16) + scores and their bounds (2 x COLS x 260 f32; a warp's candidate
// list reuses its own column) + each warp's f32 query (8 x dpad x 4);
// ops/ivf2.py fine_binmax_smem computes the same.

#include <algorithm>

#include "fine_tile.cuh"

namespace {

using namespace ftile;

constexpr int NT = 256;      // 8 warps
constexpr int NWARPS = NT / 32;
constexpr int KALIGN = 64;   // d is padded to a multiple of the deepest k-step
constexpr int SL = fine::SLAB;
constexpr int SCW = SL + 4;  // floats per column of the score tile
constexpr int COLS = 8;      // pairs a run at most: one n8 column tile
constexpr int NB = 2;        // candidate rows rescored together
constexpr int SMEM_MAX = 232448;

// ring stages: two CTAs an SM at d = 768
template <int MODE>
__host__ __device__ constexpr int stages() { return MODE == fine::INT4 ? 5 : 3; }

// a run as warp 0 publishes it: its pairs' flat positions in the (Q, L)
// lists and their live rows, its pair count (0: no run left) and block
struct Run {
    int np, blk, x[COLS], vc[COLS];
};

template <int MODE>
size_t smem_bytes(int dpad) {
    return (size_t)stages<MODE>() * slot_bytes<MODE>() + (stages<MODE>() * 8 + 15) / 16 * 16 +
           2 * sizeof(Run) + (size_t)2 * COLS * (dpad + 8) * 2 + (size_t)2 * COLS * SCW * 4 +
           (size_t)NWARPS * dpad * 4;
}

// the pairs: keys (kbytes 2, 4 or 8 a key) the block of each pair in
// sorted order, nb for a dead one, and perm its flat position in the
// (Q, L) lists; keys == nullptr: the pairs in list order.  Windows of W
// pairs (1 in list order), CTA b taking windows b, b + G, ...
struct Pairs {
    const void* keys;
    const long long* perm;
    const int32_t* vcnt;
    const int32_t* blk;
    int kbytes, P, W, nwin, G, nb;
    __device__ __forceinline__ int flat(int s) const { return keys ? (int)perm[s] : s; }
    __device__ __forceinline__ int key(int s) const {
        if (!keys) return vcnt[s] > 0 ? blk[s] : nb;
        return kbytes == 2 ? ((const int16_t*)keys)[s]
               : kbytes == 4 ? ((const int32_t*)keys)[s]
                             : (int)((const long long*)keys)[s];
    }
    // (warp-wide) the next live run at or after position s of window c in
    // this CTA's walk: [s, e) and its block; false when none is left.  Lane
    // j returns the flat position of the run's pair j.
    __device__ __forceinline__ bool find_run(int& c, int& s, int& e, int& b, int& x,
                                             int lane) const {
        for (;;) {
            if (c >= nwin) return false;
            const int wend = min((c + 1) * W, P);
            if (s >= wend) {
                c += G;
                s = c * W;
                continue;
            }
            const int p = s + lane;
            const int k = p < wend ? key(p) : nb;
            x = p < wend ? flat(p) : 0;
            const int k0 = __shfl_sync(0xffffffffu, k, 0);
            if (k0 >= nb) {  // dead: sorted, the rest are dead too
                if (keys) return false;
                ++s;
                continue;
            }
            e = s + __ffs(~__ballot_sync(0xffffffffu, p < wend && k == k0)) - 1;
            b = k0;
            return true;
        }
    }
};

template <int MODE>
__global__ void __launch_bounds__(NT, 2)
fine_binmax_kernel(const __grid_constant__ CUtensorMap tmap, const unsigned char* __restrict__ E,
                   const float* __restrict__ scales3, const uint16_t* __restrict__ qb,
                   const Pairs pr, int L, int d, int dpad, float* __restrict__ out,
                   int32_t* __restrict__ ncand) {
    constexpr int SR = fine::stored_slab<MODE>();
    constexpr int SLOT = slot_bytes<MODE>();
    constexpr int STAGES = stages<MODE>();
    constexpr int BKV = kstep_values<MODE>();
    extern __shared__ __align__(128) unsigned char smem[];
    const int LDQ = dpad + 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* ring = smem;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + STAGES * SLOT);          // STAGES
    Run* desc = reinterpret_cast<Run*>(smem + STAGES * SLOT + (STAGES * 8 + 15) / 16 * 16);
    uint16_t* Qs = reinterpret_cast<uint16_t*>(desc + 2);                        // 2 x COLS x LDQ
    float* Sc = reinterpret_cast<float*>(Qs + (size_t)2 * COLS * LDQ);          // COLS x SCW
    float* Sa = Sc + COLS * SCW;                                                // COLS x SCW
    float* qw = Sa + COLS * SCW + warp * dpad;                                  // the warp's query

    // dead slots read nothing and score -inf
    for (int x = blockIdx.x * NT + tid; x < pr.P; x += pr.G * NT)
        if (pr.vcnt[x] <= 0) out[x] = -INFINITY;

    const int ks = dpad / BKV;
    // the loader's lookahead: within a run's k-steps, so that warp 0
    // publishes run i + 2 into run i's buffers only after run i is done
    const int LA = min(STAGES - 1, ks - 1);
    // warp 0's cursor: the window, the run [ls, le) and its block, the
    // k-step, the runs begun, whether a run is being loaded
    int lc = blockIdx.x, ls = blockIdx.x * pr.W, le = 0, lb = 0, lk = 0, lr = 0;
    bool lalive = false;
    // (warp 0) find the next run, publish its descriptor and start its
    // queries' copies into buffer lr & 1
    auto begin_run = [&]() {
        int x = 0;
        lalive = pr.find_run(lc, ls, le, lb, x, lane);
        Run* r = desc + (lr & 1);
        if (!lalive) {
            if (lane == 0) r->np = 0;
            return;
        }
        const int np = le - ls;
        if (lane < np) {
            r->x[lane] = x;
            r->vc[lane] = min(pr.vcnt[x], SL);
        }
        if (lane == 0) {
            r->np = np;
            r->blk = lb;
        }
        const int vq = dpad / 8;
        for (int i0 = 0; i0 < COLS * vq; i0 += 32) {  // uniform: the shuffle
            const int i = i0 + lane, j = min(i / vq, COLS - 1), k = (i % vq) * 8;
            const int qx = __shfl_sync(0xffffffffu, x, j);
            const bool ok = i < COLS * vq && j < np && k < d;
            if (i < COLS * vq)
                tile::cp_async16(Qs + ((size_t)(lr & 1) * COLS + j) * LDQ + k,
                                 ok ? qb + (size_t)(qx / L) * d + k : qb, ok);
        }
        tile::cp_async_commit();
    };
    // (warp 0) the box of k-step ``step``, then the next run after a run's last
    auto load = [&](int step) {
        if (warp != 0 || !lalive) return;
        if (lane == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            tma_box(ring + (step % STAGES) * SLOT, &tmap, lk * BKV, lb * SR, bar + step % STAGES,
                    SLOT);
        }
        if (++lk == ks) {
            lk = 0;
            ++lr;
            ls = le;
            begin_run();
        }
    };

    if (tid == 0) {
        for (int st = 0; st < STAGES; ++st) mbar_init(bar + st);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (warp == 0) {
        begin_run();
        tile::cp_async_wait<0>();
    }
    __syncthreads();
    for (int st = 0; st < LA; ++st) load(st);

    float acc[2][1][4], acc_abs[2][1][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][0][e] = acc_abs[m][0][e] = 0.0f;

    // the consumers' cursor: the run (its buffers cr & 1), its k-step
    int cr = 0, ck = 0, cnp = desc[0].np, cb = 0;
    int cq[1] = {-1};
    const int nvec = fine::row_vectors<MODE>(d);
    for (int step = 0; cnp > 0; ++step) {
        if (ck == 0 && warp == 0) tile::cp_async_wait<0>();  // this run's queries
        __syncthreads();  // the queries have landed for every thread, and the
                          // slot loaded next was read by all
        load(step + LA);
        mbar_wait(bar + step % STAGES, (step / STAGES) & 1);
        const Run* run = desc + (cr & 1);
        if (ck == 0) {
            cb = run->blk;
            cq[0] = g < cnp ? (cr & 1) * COLS + g : -1;
        }
        score_kstep<MODE, 1>(ring + (step % STAGES) * SLOT, Qs, LDQ, cq, ck * BKV, warp, lane,
                             acc, acc_abs);
        if (++ck < ks) continue;

        // the run is scored: accumulator e of A tile m holds logical row
        // acc_row(m, e >> 1), column 2t + (e & 1); scales after the dot
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int lr_ = acc_row<MODE>(warp, m, g, h);
                const float s = MODE == fine::BF16 ? 1.0f : scales3[(size_t)cb * SL + lr_];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float v = acc[m][0][2 * h + e], va = acc_abs[m][0][2 * h + e];
                    Sc[(2 * t + e) * SCW + lr_] = MODE == fine::BF16 ? v : v * s;
                    Sa[(2 * t + e) * SCW + lr_] = MODE == fine::BF16 ? va : va * s;
                    acc[m][0][2 * h + e] = acc_abs[m][0][2 * h + e] = 0.0f;
                }
            }
        __syncthreads();

        // a warp per pair: the certificate, then the candidates' exact scores
        if (warp < cnp) {
            const int x = run->x[warp], vc = run->vc[warp];
            float sv[8], ev[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = warp * SCW + 8 * lane + 4 * h;
                const float4 a = *reinterpret_cast<const float4*>(Sc + o);
                const float4 b = *reinterpret_cast<const float4*>(Sa + o);
                sv[4 * h] = a.x, sv[4 * h + 1] = a.y, sv[4 * h + 2] = a.z, sv[4 * h + 3] = a.w;
                ev[4 * h] = b.x, ev[4 * h + 1] = b.y, ev[4 * h + 2] = b.z, ev[4 * h + 3] = b.w;
            }
            float lo = -INFINITY;  // M: the largest lower bound of a live row
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                ev[jj] *= ERR;
                if (8 * lane + jj < vc) lo = fmaxf(lo, sv[jj] - ev[jj]);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                lo = fmaxf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            __syncwarp();  // the column is in registers: its scores' room holds the list
            int* slist = reinterpret_cast<int*>(Sc + warp * SCW);
            int ns = 0;  // the live rows whose upper bound reaches M, listed
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const bool in = 8 * lane + jj < vc && sv[jj] + ev[jj] >= lo;
                const unsigned ball = __ballot_sync(0xffffffffu, in);
                if (in) slist[ns + __popc(ball & ((1u << lane) - 1))] = 8 * lane + jj;
                ns += __popc(ball);
            }
            // the query as f32, fine_scores' operand
            for (int j = lane; j < d; j += 32)
                qw[j] = __uint_as_float((uint32_t)Qs[(size_t)((cr & 1) * COLS + warp) * LDQ + j]
                                        << 16);
            __syncwarp();
            const uint4* slab = reinterpret_cast<const uint4*>(E) + (size_t)cb * SR * nvec;
            float best = -INFINITY;
            for (int b = 0; b < ns; b += NB) {
                int rows[NB], sp[NB];
#pragma unroll
                for (int u = 0; u < NB; ++u) {
                    rows[u] = b + u < ns ? slist[b + u] : -1;
                    sp[u] = rows[u] < 0 ? -1 : (MODE == fine::INT4 ? rows[u] % (SL / 2) : rows[u]);
                }
                float dh[NB], dl[NB];
                score_any_rows<MODE, NB>(slab, nvec, sp, qw, lane, dh, dl);
#pragma unroll
                for (int u = 0; u < NB; ++u) {
                    if (rows[u] < 0) continue;
                    float a = MODE == fine::INT4 && rows[u] >= SL / 2 ? dl[u] : dh[u];
                    if (MODE != fine::BF16) a = a * scales3[(size_t)cb * SL + rows[u]];
                    best = fmaxf(best, a);
                }
            }
            if (lane == 0) {
                out[x] = best;
                if (ncand) ncand[x] = ns;
            }
        }
        // the score tiles are written again only after a later step's
        // barrier; the next run's descriptor was published before this one's
        // last barrier
        ck = 0;
        ++cr;
        cnp = desc[cr & 1].np;
    }
}

template <int MODE>
int launch(const void* E, const void* sc, const void* q, const Pairs& pr, int L, int d,
           void* out, void* ncand, cudaStream_t s) {
    CUtensorMap tmap;
    const int merr = slab_map<MODE>(&tmap, E, pr.nb, d);
    if (merr != 0) return merr;
    const int dpad = (d + KALIGN - 1) / KALIGN * KALIGN;
    auto kern = fine_binmax_kernel<MODE>;
    cudaError_t err;
    static bool ready = false;  // the shared-memory limit, once
    if (!ready) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    const size_t smem = smem_bytes<MODE>(dpad);
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
    Pairs p = pr;
    p.G = std::max(1, std::min(p.nwin, sms * std::max(per_sm, 1)));
    kern<<<p.G, NT, smem, s>>>(tmap, (const unsigned char*)E, (const float*)sc,
                               (const uint16_t*)q, p, L, d, dpad, (float*)out, (int32_t*)ncand);
    return (int)cudaGetLastError();
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128,
// d) packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused
// for bf16), q_bf16 (Q, d) bf16 bits (16-byte aligned), blk/vcnt (Q, L)
// int32 (P = Q L pairs); keys (P) the pairs' blocks sorted ascending,
// nblocks for a dead slot, kbytes (2, 4 or 8) bytes a key, and perm (P)
// int64 their flat positions in (Q, L) (ops/ivf2.py fine_binmax_pairs), or
// both null: the pairs in list order; window (1 to 8; 1 in list order) the
// pairs a window (ops/binmax_topk.py pair_window).  out (Q, L) f32; ncand (Q, L) int32
// or null: each live pair's rescored rows.  d % 16 == 0, d <= 1024 (checked
// by the Python wrapper).  Returns the launch's cudaError_t.
extern "C" int fine_binmax(const void* E_c3, int mode, const void* scales3, const void* q_bf16,
                           const void* blk, const void* vcnt, const void* keys, int kbytes,
                           const void* perm, int window, int P, int L, int nblocks, int d,
                           void* out, void* ncand, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (window < 1 || window > COLS) return (int)cudaErrorInvalidValue;
    const Pairs pr{keys, (const long long*)perm, (const int32_t*)vcnt, (const int32_t*)blk,
                   kbytes, P, window, (P + window - 1) / window, 1, nblocks};
    if (mode == fine::INT4)
        return launch<fine::INT4>(E_c3, scales3, q_bf16, pr, L, d, out, ncand, s);
    if (mode == fine::INT8)
        return launch<fine::INT8>(E_c3, scales3, q_bf16, pr, L, d, out, ncand, s);
    return launch<fine::BF16>(E_c3, scales3, q_bf16, pr, L, d, out, ncand, s);
}
