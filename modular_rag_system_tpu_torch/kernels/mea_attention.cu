// mea_attention: memory-efficient self-attention of the encoder on Hopper.
//
// Replaces modular_rag_system_tpu/ops/flash_attention.py:_mea_kernel (via
// mea_attention).  For q, k, v (B, L, H, dh) in the model dtype (bf16 or
// f32) and a key-padding mask pad (B, L) (1 = live) it computes, per batch
// row and head,
//
//     out = softmax(q k^T / sqrt(dh), masked keys at -1e9) v
//
// with the TPU kernel's rounding: the scores are f32 sums of the operands'
// products times the scale, only keys are masked, at a finite -1e9, the
// maximum is the row's final maximum, the probabilities exp(s - m) are
// rounded to the model dtype before they multiply v, that product
// accumulates in f32, and the row sum of the unrounded exponentials,
// floored at 1e-30, divides at the end.  The TPU kernel pads the keys to
// Lp (padded_length below) with keys that score -1e9 and carry zero rows
// of v: they count only in a row whose keys are all padding (its maximum
// is -1e9, so each adds exp(0) = 1 to the sum), and the kernel adds Lp - L
// to such a row's sum.  The tensors are read as laid out: no transposed
// copy of k and no (L, L) tensor in global memory.
//
// Bound: q, k, v read and out written once (4 B L H dh values) against
// 6 B H L^2 dh operations (two sweeps over k: 2 for q k^T in each, 2 for
// p v in the second; one sweep would be 4 B H L^2 dh): by operations from
// L of a few hundred on, by bytes at the encoder's L <= 128.
//
// bf16 mode (the model dtype on the card), after FlashAttention-2 with
// the arithmetic above: each warp owns 16 query rows, whose q fragments
// stay in registers; q k^T and p v are mma.sync m16n8k16 bf16 products
// with f32 accumulators; the score tile stays in registers and its
// accumulator fragments, rounded to bf16, are the A fragments of p v.  k
// and v move as 16-byte cp.async copies into a double-buffered ring of
// bf16 tiles (rows padded by 16 bytes, so the ldmatrix reads are free of
// bank conflicts), dh padded to a multiple of 16 with zeros, so the next
// tile's load overlaps this tile's products.  Sweep 1 takes each row's
// maximum only; sweep 2 recomputes the scores, forms exp(s - m) with the
// final maximum, sums it unrounded and multiplies its bf16 rounding into
// v.  Where L fits one key tile the scores stay in registers between the
// sweeps (one load of k and v, one q k^T).  A CTA holds four warps; at L
// <= 32 they take two or four (batch row, head) pairs, so no warp runs on
// padding rows at the engine's L = 32.
//
// The tensor cores sum the exact bf16 products in another order than the
// plain version's f32 matrix product, and one unit in the last place of a
// score moves p across a bf16 rounding midpoint often enough to break the
// one-bf16-step tolerance at small outputs.  So each score carries a
// certificate: |tensor-core score - sequential score| <= cb |q| |k|
// (exact_score).  Sweep 1 recomputes, in the plain version's order, every
// key that comes within those bounds of its row's running maximum, so the
// maximum is the plain version's; sweep 2 recomputes every p that lies
// within its bound of a bf16 midpoint (about 1% of them, spread over a
// warp's 32 lanes), so each bf16 p is the plain version's.  The other p
// are taken from ex2.approx, inside the same bound.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), bf16,
// dh 32: 0.0677 ms at the engine's shape (B=256, L=32, H=12; bound 0.0075
// ms by bytes), where scaled_dot_product_attention takes 0.1224 ms; with
// B x H = 96, 1.8013 ms at L = 2048 and 6.7937 ms at L = 4096 (bounds
// 0.0782 and 0.3127 ms by operations; the library 0.4056 and 1.4399 ms).
// Past a few hundred keys the CUDA-core work per score (the f32 expf of
// the plain version's rounding, the certificate's tests, the masks)
// holds it back, not the tensor cores.
//
// Hopper design (entry design 1: the full mode in bf16 at dh 64, which
// the wrapper picks from L = LONG_FROM on; namespace hopper below, sharing
// no tile logic with the template): the same arithmetic and certificate.
// A prologue launch writes each key's bound factor (cb |k|, -1 padded, -2
// past L) and each 128-key tile's largest factor and live and padded
// counts once a launch.  A CTA holds 128 query rows of one (batch row,
// head) in two consumer warpgroups and a producer warpgroup (one lane
// issues the copies) that streams 128-key k (and, in sweep 2, v) tiles by
// TMA in the 128-byte swizzle into a four-slot mbarrier ring with the
// tiles' records; q k^T and p v run on wgmma (q and p from registers, k
// and v from shared memory).  Tiles of
// live keys skip the masks, a padded key's p is one value a row, tiles of
// padding take it whole; sweep 1 tests a tile's largest score against the
// running maximum first and queues the keys it flags, whose exact scores
// are taken once at the sweep's end (from k in device memory); sweep 2's
// flagged p (0.6-2% of the live ones) are recomputed by the warp's lanes
// from a list before the tile's p v.  Measured by chip_smoke.py phase 7b on
// an NVIDIA H100 80GB HBM3 (700 W) at ModernBERT's first global layer's
// inputs (8 x 8,192, H 12, ragged): 10.74 ms, where the template takes
// 36.57 ms and scaled_dot_product_attention 5.50 ms (bound 2.50 ms, two
// sweeps); the certificate's tests and recomputations are ~4.3 ms of it
// (a build without them, which is not exact, takes ~5.8 ms).

// f32 mode (the f32 model): products on the CUDA cores in f32 (a 4 x 4
// register tile of scores per thread), exact in f32 with no TF32; one CTA
// per (batch row x head, 64 query rows), k and v through shared memory in
// 64-key tiles, sweep 1 keeping a running maximum and sum.
//
// Window mode (entry mea_attention_window, the sliding-window layers of
// ModernBERT; no TPU kernel computes it): query i sees only the keys j
// with |i - j| <= w.  A key outside the band is no key of the row: it adds
// nothing to the row's maximum or sum.  A padded key inside the band
// scores -1e9 as in the full mode.  A row whose band holds no live key
// (its maximum is -1e9) is written as zeros, and the TPU padding rule
// does not apply.  Each CTA loads and scores only the key tiles that meet
// the band of its query rows, [q_lo - w, q_hi + w], in both sweeps.  The
// mode is the kernels' WIN template flag, so the profiler's kernel names
// tell the two modes apart; with WIN false every band test folds away and
// the full mode is compiled as before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr float MASKED = -1e9f;

// the key length the TPU kernel pads L to: L up to 128, then up to its
// query block, min(512, that)
__device__ __forceinline__ int padded_length(int L) {
    const int lp = (L + 127) / 128 * 128;
    const int blk = lp < 512 ? lp : 512;
    return (lp + blk - 1) / blk * blk;
}

// ---------------------------------------------------------------------------
// bf16 mode: tensor-core tiles

constexpr int NW = 4;  // warps per CTA
constexpr int NTB = NW * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (relative error below 2^-22; subnormal results flushed)
__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// acc + the squares of the eight bf16 values of x
__device__ __forceinline__ float sumsq8(const uint4& x, float acc) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float lo = topk::bf16_lo(w[i]), hi = topk::bf16_hi(w[i]);
        acc = fmaf(lo, lo, acc);
        acc = fmaf(hi, hi, acc);
    }
    return acc;
}

// A score as the plain version's f32 matrix product forms it: one FMA per
// column, in column order, from 0, times the scale.  The tensor cores sum
// the same exact bf16 products in another order, which can move a score
// by a few units in its last place, and a p near a bf16 rounding midpoint
// (or a near-tie for the row maximum) then rounds the other way: one bf16
// step of a probability, which at a small output is more than one bf16
// step of the output.  So the scores that could round otherwise are
// recomputed here (about 1% of them), and the kernel's p and maxima are
// those of the plain version.
__device__ __forceinline__ float exact_score(const uint16_t* qrow, const uint16_t* krow, int dh,
                                          float scale) {
    float acc = 0.0f;
    for (int c = 0; c < dh; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(qrow + c);
        const uint4 b = *reinterpret_cast<const uint4*>(krow + c);
        const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            acc = fmaf(topk::bf16_lo(wa[i]), topk::bf16_lo(wb[i]), acc);
            acc = fmaf(topk::bf16_hi(wa[i]), topk::bf16_hi(wb[i]), acc);
        }
    }
    return __fmul_rn(acc, scale);  // rounded, never fused into a later subtraction
}

// DHP: dh rounded up to a multiple of 16; BKV: keys per tile; WPP: warps
// per (batch row, head) pair, each 16 query rows, NW / WPP pairs per CTA
template <int DHP, int BKV, int WPP>
struct Tiles {
    static constexpr int PPC = NW / WPP;
    static constexpr int LDK = DHP + 8;  // bf16 values per staged key row
    static constexpr int KV = BKV * LDK;  // bf16 values of one k or v tile
    // one ring slot: per pair a k tile, a v tile and BKV live flags (which
    // become the keys' score bounds)
    static constexpr int SLOT = PPC * (2 * KV * 2 + BKV * 4);
    // per warp: its 16 q rows, its rows' maxima, and the list of scores to
    // recompute (at most BKV / 2 a lane)
    static constexpr int NP = BKV / 2;
    static constexpr int WARP = 16 * LDK * 2 + 16 * 4 + 32 * NP * 4;
    static constexpr int SMEM = 2 * SLOT + NW * WARP;
};

template <int DHP, int BKV, int WPP, bool WIN>
__global__ void __launch_bounds__(NTB)
mea_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, const float* __restrict__ pad,
                uint16_t* __restrict__ out, int BH, int L, int H, int dh, float scale, int w) {
    using T = Tiles<DHP, BKV, WPP>;
    constexpr int NI = BKV / 8;   // score n-tiles (8 keys each)
    constexpr int KD = DHP / 16;  // k-steps of q k^T
    constexpr int ND = DHP / 8;   // output n-tiles (8 columns each)
    constexpr int CPR = DHP / 8;  // 16-byte chunks of a staged row
    extern __shared__ __align__(16) unsigned char sm[];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int pair0 = blockIdx.y * T::PPC;
    const size_t rstride = (size_t)H * dh;  // values between positions

    // this warp's pair and query rows
    const int pp = warp / WPP;
    const int pair = pair0 + pp;
    const int q0 = (blockIdx.x * WPP + warp % WPP) * 16;
    const bool active = pair < BH && q0 < L;

    auto kt_ptr = [&](int slot, int p) {
        return reinterpret_cast<uint16_t*>(sm + slot * T::SLOT) + (size_t)p * 2 * T::KV;
    };
    auto live_ptr = [&](int slot, int p) {
        return reinterpret_cast<float*>(sm + slot * T::SLOT + T::PPC * 2 * T::KV * 2) +
               p * BKV;
    };
    auto base_of = [&](int pr) {  // value (b, 0, h, 0) of pair pr
        return ((size_t)(pr / H) * L * H + pr % H) * dh;
    };

    // the key tiles kt0 .. kt0 + nt - 1 this CTA sweeps: all of them, or
    // those that meet the band of its query rows
    int kt0 = 0, nt = (L + BKV - 1) / BKV;
    if (WIN) {
        const int qlo = blockIdx.x * WPP * 16;
        const int qhi = min(qlo + WPP * 16, L) - 1;
        kt0 = max(qlo - w, 0) / BKV;
        nt = min(qhi + w, L - 1) / BKV - kt0 + 1;
    }
    // one key tile: the scores stay in registers between the sweeps
    const int first2 = nt == 1 ? 0 : nt;
    const int steps = first2 + nt;

    auto load_step = [&](int s) {
        const int slot = s & 1;
        const int k0 = (kt0 + s % nt) * BKV;
        const bool with_v = s >= first2;
        for (int i = tid; i < T::PPC * BKV * CPR; i += NTB) {
            const int p = i / (BKV * CPR), r = (i / CPR) % BKV, c = i % CPR;
            const int j = k0 + r, pr = pair0 + p;
            const bool ok = pr < BH && j < L && c * 8 < dh;
            const size_t off = ok ? base_of(pr) + (size_t)j * rstride + c * 8 : 0;
            uint16_t* Ks = kt_ptr(slot, p);
            cp_async16(Ks + r * T::LDK + c * 8, k + off, ok);
            if (with_v) cp_async16(Ks + T::KV + r * T::LDK + c * 8, v + off, ok);
        }
        for (int i = tid; i < T::PPC * BKV; i += NTB) {
            const int p = i / BKV, r = i % BKV, j = k0 + r, pr = pair0 + p;
            const bool ok = pr < BH && j < L;
            cp_async4(live_ptr(slot, p) + r, pad + (ok ? (size_t)(pr / H) * L + j : 0), ok);
        }
    };

    load_step(0);
    cp_async_commit();

    // this warp's 16 q rows in shared memory (zero past L and dh), for
    // its q fragments and for the certificate's recomputations
    unsigned char* wscr = sm + 2 * T::SLOT + warp * T::WARP;
    uint16_t* qs = reinterpret_cast<uint16_t*>(wscr);                     // 16 x LDK
    float* mrow = reinterpret_cast<float*>(wscr + 16 * T::LDK * 2);        // 16
    float* list = mrow + 16;                                               // 32 NP
    if (active) {
        const size_t base = base_of(pair);
        for (int i = lane; i < 16 * CPR; i += 32) {
            const int r = i / CPR, c = i % CPR, row = q0 + r;
            uint4 x = make_uint4(0, 0, 0, 0);
            if (row < L && c * 8 < dh)
                x = *reinterpret_cast<const uint4*>(q + base + (size_t)row * rstride + c * 8);
            *reinterpret_cast<uint4*>(qs + r * T::LDK + c * 8) = x;
        }
    }
    __syncwarp();
    // the q fragments of rows g and g + 8, and the rows' norms
    uint32_t qa[KD][4];
    {
        const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int kc = 0; kc < KD; ++kc)
            ldmatrix_x4(qa[kc], qs + ((mat & 1) * 8 + r8) * T::LDK + kc * 16 + (mat >> 1) * 8);
    }
    float qn[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float lo = topk::bf16_lo(qa[kc][i]), hi = topk::bf16_hi(qa[kc][i]);
            qn[i & 1] = fmaf(lo, lo, fmaf(hi, hi, qn[i & 1]));
        }
    bool rowok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
        qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
        qn[r] = sqrtf(qn[r]);
        rowok[r] = active && q0 + g + 8 * r < L;
    }
    // |tensor-core score - sequential f32 score| <= cb |q| |k|: dh roundings
    // of at most 2^-24 |q| |k| each in the sequential sum (Cauchy-Schwarz
    // bounds every partial sum), the tensor cores' own and the scale's
    const float cb = (1.25f * (float)dh + 8.0f) * 0x1p-24f * scale;

    float sacc[NI][4];
    float oacc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8: the exact maxima
    float ma[2] = {-INFINITY, -INFINITY};  // ... of the tensor-core scores so far
    float er[2] = {0.0f, 0.0f};            // ... and their largest bound
    float lsum[2] = {0.0f, 0.0f};

    // The flagged positions of a tile (bit n * 4 + e of each lane's flag),
    // recomputed by all lanes at once from a per-warp list: the exact
    // score (sweep 1) or exp(exact score - m) (sweep 2) of each, handed to
    // fn(position, value) in the flagging lane.
    auto resolve = [&](uint32_t flag, const uint16_t* Ks, bool prob, auto&& fn) {
        const int cnt = __popc(flag);
        int off = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, off, o);
            if (lane >= o) off += y;
        }
        const int total = __shfl_sync(0xffffffffu, off, 31);
        if (total == 0) return;
        off -= cnt;
        int* codes = reinterpret_cast<int*>(list);
        int w = off;
        for (uint32_t f = flag; f; f &= f - 1) codes[w++] = (__ffs(f) - 1) | (lane << 8);
        __syncwarp();
        for (int i = lane; i < total; i += 32) {
            const int code = codes[i], b = code & 0xFF, ln = code >> 8, e = b & 3;
            const int row = (ln >> 2) + 8 * (e >> 1), col = (b >> 2) * 8 + 2 * (ln & 3) + (e & 1);
            const float sc = exact_score(qs + row * T::LDK, Ks + col * T::LDK, dh, scale);
            list[i] = prob ? expf(__fsub_rn(sc, mrow[row])) : sc;
        }
        __syncwarp();
        w = off;
#pragma unroll
        for (int b = 0; b < T::NP; ++b)
            if (flag & (1u << b)) fn(b, list[w++]);
        __syncwarp();  // the list is rewritten by the next call
    };

    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) load_step(s + 1);
        cp_async_commit();
        cp_async_wait<1>();  // step s's tiles have landed
        __syncthreads();
        {
            // each key's live flag becomes its score bound's factor: cb |k|
            // for a live key, -1 for a padded one, -2 past L (two threads a
            // key, each half of its values)
            const int slot = s & 1;
            const int k0 = (kt0 + s % nt) * BKV;
            for (int i = tid; i < T::PPC * BKV * 2; i += NTB) {
                const int p = i / (2 * BKV), r = (i / 2) % BKV, h = i & 1;
                const uint16_t* kr = kt_ptr(slot, p) + r * T::LDK;
                float s2 = 0.0f;
                for (int c = h; c < CPR; c += 2)
                    s2 = sumsq8(*reinterpret_cast<const uint4*>(kr + c * 8), s2);
                s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
                float* lv = live_ptr(slot, p) + r;
                const float code = pair0 + p >= BH || k0 + r >= L ? -2.0f
                                   : *lv > 0.5f               ? cb * sqrtf(s2)
                                                              : -1.0f;
                __syncwarp();  // both threads have read the flag
                if (h == 0) *lv = code;
            }
        }
        __syncthreads();
        if (active) {
            const int slot = s & 1;
            const int k0 = (kt0 + s % nt) * BKV;
            const uint16_t* Ks = kt_ptr(slot, pp);
            const float* kb = live_ptr(slot, pp);
            const int mat = lane >> 3, r8 = lane & 7;
            // key col's bound factor for row g + 8 r: -2 (no key of the
            // row) outside the band
            auto kcode = [&](int r, int col) {
                return WIN && abs(q0 + g + 8 * r - k0 - col) > w ? -2.0f : kb[col];
            };
            // raw scores q k^T over DHP, k fragments by ldmatrix (key rows)
#pragma unroll
            for (int n = 0; n < NI; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
            for (int kc = 0; kc < KD; ++kc)
#pragma unroll
                for (int np = 0; np < NI / 2; ++np) {
                    uint32_t b[4];
                    ldmatrix_x4(b, Ks + (np * 16 + (mat >> 1) * 8 + r8) * T::LDK + kc * 16 +
                                       (mat & 1) * 8);
                    mma_bf16(sacc[2 * np], qa[kc], b[0], b[1]);
                    mma_bf16(sacc[2 * np + 1], qa[kc], b[2], b[3]);
                }

            if (s < first2 || nt == 1) {
                // sweep 1: the exact row maxima.  With ma the largest
                // tensor-core score of the row so far (this tile included)
                // and er the largest bound, the row's maximum key k* has
                // sa(k*) + e(k*) >= s(k*) >= ma - er; the keys that pass
                // that test are recomputed (about one a tile), and the
                // row's maximum is always among them.
                float ta[2] = {-INFINITY, -INFINITY}, te[2] = {0.0f, 0.0f};
#pragma unroll
                for (int n = 0; n < NI; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = n * 8 + 2 * t + (e & 1), r = e >> 1;
                        const float kbv = kcode(r, col);
                        if (kbv >= 0.0f) {
                            ta[r] = fmaxf(ta[r], sacc[n][e] * scale);
                            te[r] = fmaxf(te[r], kbv * qn[r]);
                        } else if (kbv > -1.5f) {
                            m[r] = fmaxf(m[r], MASKED);
                        }
                    }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
#pragma unroll
                    for (int off = 1; off < 4; off <<= 1) {
                        ta[r] = fmaxf(ta[r], __shfl_xor_sync(0xffffffffu, ta[r], off));
                        te[r] = fmaxf(te[r], __shfl_xor_sync(0xffffffffu, te[r], off));
                    }
                    ma[r] = fmaxf(ma[r], ta[r]);
                    er[r] = fmaxf(er[r], te[r]);
                }
                uint32_t flag = 0;
#pragma unroll
                for (int n = 0; n < NI; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = n * 8 + 2 * t + (e & 1), r = e >> 1;
                        const float kbv = kcode(r, col);
                        if (kbv >= 0.0f && rowok[r] &&
                            fmaf(kbv, qn[r], sacc[n][e] * scale) >= ma[r] - er[r])
                            flag |= 1u << (n * 4 + e);
                    }
                resolve(flag, Ks, false, [&](int b, float sc) {
                    if (b & 2) m[1] = fmaxf(m[1], sc);
                    else m[0] = fmaxf(m[0], sc);
                });
            }
            if (s == first2) {  // the rows' final maxima (four lanes a row)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
                    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
                    if (t == 0) mrow[g + 8 * r] = m[r];
                }
                __syncwarp();
            }
            if (s >= first2) {
                // sweep 2: p = exp(s - m) in place of the scores.  A p whose
                // f32 value lies within the score bound of a bf16 rounding
                // midpoint is flagged and recomputed from the exact score.
                uint32_t flag = 0;
#pragma unroll
                for (int n = 0; n < NI; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = n * 8 + 2 * t + (e & 1), r = e >> 1;
                        const float kbv = kcode(r, col);
                        float pv = 0.0f;
                        if (kbv >= 0.0f) {
                            const float x = sacc[n][e] * scale - m[r];
                            pv = ex2_approx(x * 1.44269504f);
                            // the bf16 rounding midpoint nearest pv, and pv's
                            // relative uncertainty against the plain version's
                            // expf(s - m): the score bound, the roundings of x
                            // and of x log2(e), and both exponentials' errors
                            const float mid =
                                __uint_as_float((__float_as_uint(pv) & 0xFFFF0000u) | 0x8000u);
                            const float rel = fmaf(fabsf(x), 0x1p-22f, fmaf(kbv, qn[r], 0x1p-20f));
                            if (fabsf(pv - mid) <= pv * rel && rowok[r]) flag |= 1u << (n * 4 + e);
                        } else if (kbv > -1.5f) {
                            pv = expf(MASKED - m[r]);
                        }
                        sacc[n][e] = pv;
                    }
                resolve(flag, Ks, true, [&](int b, float pv) {
#pragma unroll
                    for (int n = 0; n < NI; ++n)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (b == n * 4 + e) sacc[n][e] = pv;
                });
                // summed unrounded, rounded to bf16 as the A fragments of
                // p v (16 keys a k-step)
                const uint16_t* Vs = Ks + T::KV;
#pragma unroll
                for (int kc = 0; kc < NI / 2; ++kc) {
#pragma unroll
                    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
                        for (int e = 0; e < 4; ++e) lsum[e >> 1] += sacc[2 * kc + h2][e];
                    uint32_t pa[4];
                    pa[0] = pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]);
                    pa[1] = pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]);
                    pa[2] = pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]);
                    pa[3] = pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3]);
#pragma unroll
                    for (int dp = 0; dp < ND / 2; ++dp) {
                        uint32_t b[4];
                        ldmatrix_x4_trans(b, Vs + (kc * 16 + (mat & 1) * 8 + r8) * T::LDK +
                                                 dp * 16 + (mat >> 1) * 8);
                        mma_bf16(oacc[2 * dp], pa, b[0], b[1]);
                        mma_bf16(oacc[2 * dp + 1], pa, b[2], b[3]);
                    }
                }
            }
        }
        __syncthreads();  // this slot is free for the load two steps on
    }
    cp_async_wait<0>();

    if (!active) return;
    const float extra = (float)(padded_length(L) - L);
    float denom[2];
    bool dead[2];  // window mode: no live key in the row's band
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
        dead[r] = WIN && m[r] == MASKED;
        if (!WIN && m[r] == MASKED) lsum[r] += extra;  // all keys padding
        denom[r] = fmaxf(lsum[r], 1e-30f);
    }
    const size_t base = base_of(pair);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row >= L) continue;
        uint16_t* o = out + base + (size_t)row * rstride;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const int c = n * 8 + 2 * t;
            if (c < dh)
                *reinterpret_cast<uint32_t*>(o + c) =
                    dead[r] ? 0u
                            : pack_bf16(oacc[n][2 * r] / denom[r], oacc[n][2 * r + 1] / denom[r]);
        }
    }
}

template <int DHP, int BKV, int WPP, bool WIN>
int launch_bf16(const void* q, const void* k, const void* v, const void* pad, void* out, int B,
                int L, int H, int dh, float scale, int w, cudaStream_t stream) {
    using T = Tiles<DHP, BKV, WPP>;
    auto kern = mea_bf16_kernel<DHP, BKV, WPP, WIN>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int BH = B * H;
    const int nqb = (L + 15) / 16;
    const dim3 grid((nqb + WPP - 1) / WPP, (BH + T::PPC - 1) / T::PPC);
    kern<<<grid, NTB, T::SMEM, stream>>>((const uint16_t*)q, (const uint16_t*)k,
                                         (const uint16_t*)v, (const float*)pad, (uint16_t*)out,
                                         BH, L, H, dh, scale, w);
    return (int)cudaGetLastError();
}

template <int DHP, bool WIN>
int dispatch_bf16(const void* q, const void* k, const void* v, const void* pad, void* out,
                  int B, int L, int H, int dh, float scale, int w, cudaStream_t s) {
    // L <= 32: one 32-key tile, and a CTA's four warps over four or two
    // pairs (one or two 16-row query blocks each); else 64-key tiles and
    // four query blocks of one pair
    if (L <= 16)
        return launch_bf16<DHP, 32, 1, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
    if (L <= 32)
        return launch_bf16<DHP, 32, 2, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
    return launch_bf16<DHP, 64, 4, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
}

// ---------------------------------------------------------------------------
// f32 mode: CUDA-core products

constexpr int NT = 256;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per tile
constexpr int LDS = BK + 1;

// a tile of 64 keys (and their values) in shared memory; keys at or past L
// are zero rows marked -1, padded keys are marked 0, live keys 1
__device__ __forceinline__ void load_tile(const float* k, const float* v, const float* pad_row,
                                          size_t base, size_t rstride, int k0, int L, int dh,
                                          int ldq, float* Ks, float* Vs, float* live,
                                          bool with_v) {
    for (int idx = threadIdx.x; idx < BK * dh; idx += NT) {
        const int r = idx / dh, c = idx % dh, j = k0 + r;
        const size_t g = base + (size_t)j * rstride + c;
        Ks[r * ldq + c] = j < L ? k[g] : 0.0f;
        if (with_v) Vs[r * dh + c] = j < L ? v[g] : 0.0f;
    }
    for (int r = threadIdx.x; r < BK; r += NT) {
        const int j = k0 + r;
        live[r] = j < L ? (pad_row[j] > 0.5f ? 1.0f : 0.0f) : -1.0f;
    }
}

// Ss[r][c] = scale * q_r . k_c for the 64 x 64 tile, masked keys at -1e9,
// keys past L (and, WIN, keys outside the band of query row q0 + r, key
// k0 + c) at -inf; each thread a 4 x 4 register tile
template <bool WIN>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks, const float* live,
                                           int dh, int ldq, float scale, float* Ss, int q0,
                                           int k0, int w) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int dd = 0; dd < dh; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float lv = live[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float s = acc[i][j] * scale;
            const bool out_of_band = WIN && abs(q0 + ty + 16 * i - k0 - c) > w;
            Ss[(ty + 16 * i) * LDS + c] =
                lv > 0.5f && !out_of_band ? s
                                          : (lv < -0.5f || out_of_band ? -INFINITY : MASKED);
        }
    }
}

// DHP: dh rounded up to 32, 64 or 128 (the output accumulators per thread)
template <int DHP, bool WIN>
__global__ void __launch_bounds__(NT)
mea_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ pad,
               float* __restrict__ out, int L, int H, int dh, float scale, int w) {
    extern __shared__ float smf[];
    const int ldq = dh + 1;
    float* Qs = smf;              // BQ x ldq
    float* Ks = Qs + BQ * ldq;    // BK x ldq
    float* Vs = Ks + BK * ldq;    // BK x dh
    float* Ss = Vs + BK * dh;     // BQ x LDS
    float* live = Ss + BQ * LDS;  // BK

    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const size_t rstride = (size_t)H * dh;             // values between positions
    const size_t base = ((size_t)b * L * H + h) * dh;  // value (b, 0, h, 0)
    const float* pad_row = pad + (size_t)b * L;

    for (int idx = threadIdx.x; idx < BQ * dh; idx += NT) {
        const int r = idx / dh, c = idx % dh, l = q0 + r;
        Qs[r * ldq + c] = l < L ? q[base + (size_t)l * rstride + c] : 0.0f;
    }

    // four threads own one query row: its statistics and its output
    const int srow = threadIdx.x / 4, spart = threadIdx.x % 4;
    float m_run = -INFINITY, l_run = 0.0f;
    // the key tiles swept: all, or those that meet the band of the rows
    const int kbeg = WIN ? max(q0 - w, 0) / BK * BK : 0;
    const int kend = WIN ? min(q0 + BQ + w, L) : L;

    // sweep 1: the row maxima and the sums of exp(s - m)
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        __syncthreads();  // the previous tile is done with
        load_tile(k, v, pad_row, base, rstride, k0, L, dh, ldq, Ks, Vs, live, false);
        __syncthreads();
        score_tile<WIN>(Qs, Ks, live, dh, ldq, scale, Ss, q0, k0, w);
        __syncthreads();
        float tmax = -INFINITY;
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) tmax = fmaxf(tmax, Ss[srow * LDS + spart + 4 * cc]);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        // a tile holds a key below L, so the new maximum is finite; in
        // window mode a row may have no key in this tile nor before it
        const float m_new = fmaxf(m_run, tmax);
        const float m_ref = WIN && m_new == -INFINITY ? 0.0f : m_new;
        float sum = 0.0f;
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) sum += expf(Ss[srow * LDS + spart + 4 * cc] - m_ref);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run = l_run * expf(m_run - m_ref) + sum;
        m_run = m_new;
    }

    // sweep 2: exp(s - m) times v, summed in f32
    float o[DHP / 4];
#pragma unroll
    for (int jj = 0; jj < DHP / 4; ++jj) o[jj] = 0.0f;
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        __syncthreads();
        load_tile(k, v, pad_row, base, rstride, k0, L, dh, ldq, Ks, Vs, live, true);
        __syncthreads();
        score_tile<WIN>(Qs, Ks, live, dh, ldq, scale, Ss, q0, k0, w);
        __syncthreads();
#pragma unroll
        for (int cc = 0; cc < BK / 4; ++cc) {
            float* s = Ss + srow * LDS + spart + 4 * cc;
            *s = expf(*s - m_run);
        }
        __syncwarp();  // a row's four threads are in one warp
        for (int kk = 0; kk < BK; ++kk) {
            const float p = Ss[srow * LDS + kk];
#pragma unroll
            for (int jj = 0; jj < DHP / 4; ++jj) {
                const int c = spart + 4 * jj;
                if (c < dh) o[jj] += p * Vs[kk * dh + c];
            }
        }
    }

    const int l = q0 + srow;
    if (l < L) {
        // all keys padding: the TPU padding rule, or (window) zeros
        const bool dead = WIN && m_run == MASKED;
        if (!WIN && m_run == MASKED) l_run += (float)(padded_length(L) - L);
        const float denom = fmaxf(l_run, 1e-30f);
        const size_t g = base + (size_t)l * rstride;
#pragma unroll
        for (int jj = 0; jj < DHP / 4; ++jj) {
            const int c = spart + 4 * jj;
            if (c < dh) out[g + c] = dead ? 0.0f : o[jj] / denom;
        }
    }
}

template <int DHP, bool WIN>
int launch_f32(const void* q, const void* k, const void* v, const void* pad, void* out, int B,
               int L, int H, int dh, float scale, int w, cudaStream_t stream) {
    const size_t smem =
        ((size_t)(BQ + BK) * (dh + 1) + (size_t)BK * dh + (size_t)BQ * LDS + BK) * sizeof(float);
    auto kern = mea_f32_kernel<DHP, WIN>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + BQ - 1) / BQ, B * H);
    kern<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)pad, (float*)out, L, H, dh, scale, w);
    return (int)cudaGetLastError();
}

template <bool WIN>
int attend(const void* q, const void* k, const void* v, const void* pad, int is_bf16, int B, int L,
        int H, int dh, float scale, int w, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) {
        if (dh <= 16) return dispatch_bf16<16, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
        if (dh <= 32) return dispatch_bf16<32, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
        if (dh <= 48) return dispatch_bf16<48, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
        if (dh <= 64) return dispatch_bf16<64, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
        if (dh <= 96) return dispatch_bf16<96, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
        return dispatch_bf16<128, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
    }
    if (dh <= 32) return launch_f32<32, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
    if (dh <= 64) return launch_f32<64, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
    return launch_f32<128, WIN>(q, k, v, pad, out, B, L, H, dh, scale, w, s);
}

// ---------------------------------------------------------------------------
// Hopper design of the bf16 full mode at long L (dh 64): the entry's design
// 1 (see the top of the file).  It shares no tile logic with the template
// above, which keeps every other shape.

namespace hopper {

constexpr int DH = 64;                 // the head width it takes: 128-byte rows
constexpr int BM = 128;                // query rows a CTA: two consumer warpgroups of 64
constexpr int BN = 128;                // keys a tile (wgmma_qk's N)
constexpr int STAGES = 4;              // ring slots
constexpr int REC = BN + 4;            // floats of a (pair, key tile) record
constexpr int TILE = BN * DH * 2;      // bytes of a k or a v tile
constexpr int QTILE = BM * DH * 2;     // bytes of the q tile
constexpr int SLOT = 2 * TILE + 1024;  // k, v and the record (528 bytes), 1024-aligned
constexpr int LIST = 32 * BN / 2;      // a warp's recompute list: all its scores of a tile
constexpr int PEND = LIST / 2;         // ... or sweep 1's pending keys, then their scores
constexpr int SCRATCH = (16 + LIST) * 4;  // ... after the warp's 16 row maxima
constexpr int NCONS = 2 * BM;          // consumer threads: a warpgroup of 128 per 64 rows
constexpr int NWC = NCONS / 32;        // consumer warps
constexpr int NT = NCONS + 128;        // and a producer warpgroup (one lane works)
// registers a thread: at launch, and after the warpgroups' exchange
// (setmaxnreg), where the producers give up what the consumers' scores,
// outputs and p take
constexpr int LAUNCH_REGS = 65536 / NT / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (NT * LAUNCH_REGS - 128 * PRODUCER_REGS) / NCONS / 8 * 8;
constexpr int SMEM = 1024 + STAGES * SLOT + QTILE + NWC * SCRATCH + (2 * STAGES + 1) * 8;

// chunk c (16 bytes) of row r of a tile of 128-byte rows as TMA stores it
// in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}
// a wait that outlasts ~2^35 cycles (~20 s) traps: a fault, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    if (mbar_try(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - t0 > (1ll << 35)) __trap();
}
// the box of rows (c2, c2 + box) of head c1 of batch row c3
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int c1, int c2, int c3,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(c3),
        "r"(smem_addr(bar))
        : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// wgmma operand descriptors of tiles in the 128-byte swizzle, 8-row atoms
// 1024 bytes apart: k as B of q k^T (K-major: the keys are N), v as B of p
// v (MN-major: the keys are K, one 128-byte atom of dh wide, so both
// offsets are the atoms' stride)
__device__ __forceinline__ uint64_t desc_k(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_v(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers that an asynchronous wgmma reads or writes: nothing may move
// across the wait that follows it
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// q k^T: D (64 x 128, f32) = (accumulate ? D : 0) + A (64 x 16, bf16
// fragments in registers, as mma.sync m16n8k16's for each warp's 16 rows)
// x B (the descriptor's 16 x 128, K-major); the accumulators as mma.sync's
// over 16 column tiles of 8
__device__ __forceinline__ void wgmma_qk(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// p v: D (64 x 64, f32) += A (64 x 16, bf16 in registers) x B (the
// descriptor's 16 x 64, MN-major: the v rows as they lie)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc + the eight products of the bf16 values of a and b, in order
__device__ __forceinline__ float fma8(const uint4& a, const uint4& b, float acc) {
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        acc = fmaf(topk::bf16_lo(wa[i]), topk::bf16_lo(wb[i]), acc);
        acc = fmaf(topk::bf16_hi(wa[i]), topk::bf16_hi(wb[i]), acc);
    }
    return acc;
}

// exact_score with query row qr of the swizzled q tile Qs and key row kr of
// a swizzled k tile Ks, or (exact_score_g) key row k in device memory: one
// FMA a column in column order, from 0, times the scale
__device__ __forceinline__ float exact_score_sw(const unsigned char* Qs, int qr,
                                                const unsigned char* Ks, int kr, float scale) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
        acc = fma8(*reinterpret_cast<const uint4*>(Qs + swz(qr, c)),
                   *reinterpret_cast<const uint4*>(Ks + swz(kr, c)), acc);
    return __fmul_rn(acc, scale);
}
__device__ __forceinline__ float exact_score_g(const unsigned char* Qs, int qr,
                                               const uint16_t* __restrict__ k, float scale) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
        acc = fma8(*reinterpret_cast<const uint4*>(Qs + swz(qr, c)),
                   __ldg(reinterpret_cast<const uint4*>(k) + c), acc);
    return __fmul_rn(acc, scale);
}

// The key bounds, once a launch: the record of each (batch row x head,
// key tile) holds the tile's BN key codes (cb |k| for a live key, -1 for
// a padded one, -2 past L), then its largest code (0 if none is live), its
// live and its padded keys.  A thread a key.  The kernels of this design
// are named mea_bf16_kernel<..., WIN> as the template's are: the
// benchmark's roofline readers find the full mode's kernels by that name
// and its last template argument.
namespace key_bounds {

template <int D, int N, bool WIN>
__global__ void __launch_bounds__(N)
mea_bf16_kernel(const uint16_t* __restrict__ k, const float* __restrict__ pad,
                float* __restrict__ rec, int L, int H, float scale) {
    static_assert(D == DH && N == BN && !WIN, "the full mode's Hopper design");
    __shared__ float part[N / 32][3];
    const int pair = blockIdx.y, b = pair / H, h = pair % H;
    const int j = blockIdx.x * N + threadIdx.x;
    const float cb = (1.25f * (float)D + 8.0f) * 0x1p-24f * scale;
    float code = -2.0f;
    if (j < L) {
        code = -1.0f;
        if (pad[(size_t)b * L + j] > 0.5f) {
            const uint4* kr = reinterpret_cast<const uint4*>(k + (((size_t)b * L + j) * H + h) * D);
            float s2 = 0.0f;
#pragma unroll
            for (int c = 0; c < D / 8; ++c) s2 = sumsq8(kr[c], s2);
            code = cb * sqrtf(s2);
        }
    }
    float* r = rec + ((size_t)pair * gridDim.x + blockIdx.x) * REC;
    r[threadIdx.x] = code;
    float mx = fmaxf(code, 0.0f), nl = code >= 0.0f ? 1.0f : 0.0f, np = code == -1.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        nl += __shfl_xor_sync(0xffffffffu, nl, o);
        np += __shfl_xor_sync(0xffffffffu, np, o);
    }
    if ((threadIdx.x & 31) == 0) {
        part[threadIdx.x >> 5][0] = mx;
        part[threadIdx.x >> 5][1] = nl;
        part[threadIdx.x >> 5][2] = np;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < N / 32; ++w) {
            mx = fmaxf(mx, part[w][0]);
            nl += part[w][1];
            np += part[w][2];
        }
        r[N] = mx;
        r[N + 1] = nl;
        r[N + 2] = np;
        r[N + 3] = 0.0f;
    }
}

}  // namespace key_bounds

// One CTA: 128 query rows of one (batch row, head), the two sweeps over
// its key tiles.  Warp 8 is the producer: one lane loads the q tile once,
// then each step's k tile (and, in sweep 2, v tile) as TMA boxes and the
// tile's record as a bulk copy into a ring slot, signalled on the slot's
// full mbarrier, after the eight consumer warps have released the slot on
// its empty one (warps 8-11 hand most of their registers to the
// consumers).  Consumer warpgroup w owns rows 64 w .. 64 w + 63; its warps
// hold q as wgmma A fragments and issue q k^T (m64n128k16, scores in
// registers) and p v (m64n64k16, p from registers).  A sweep-2 step
// issues the previous tile's p v with this tile's q k^T, so the slot of a
// tile is released one step after its scores; while one warpgroup's exp
// and tests run, the other's products do.
template <int D, int N, bool WIN>
__global__ void __launch_bounds__(NT, 1)
mea_bf16_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const uint16_t* __restrict__ kg,
                const float* __restrict__ rec, uint16_t* __restrict__ out, int L, int H,
                float scale) {
    static_assert(D == DH && N == BN && !WIN, "the full mode's Hopper design");
    constexpr int SC = N / 2;  // a lane's scores of a tile: two rows x N / 4 keys
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    unsigned char* Qs = ring + STAGES * SLOT;
    unsigned char* scr = Qs + QTILE;
    uint64_t* full = reinterpret_cast<uint64_t*>(scr + NWC * SCRATCH);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int pair = blockIdx.y, b = pair / H, h = pair % H;
    const int q0 = blockIdx.x * BM;
    const int nt = (L + BN - 1) / BN, steps = 2 * nt;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, NWC);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= NWC) {  // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (warp == NWC && lane == 0) {
            mbar_expect(qbar, QTILE);
            tma_rows(Qs, &qmap, h, q0, b, qbar);
            for (int s = 0; s < steps; ++s) {
                const int slot = s % STAGES, use = s / STAGES;
                if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
                const int tile = s < nt ? s : s - nt;
                unsigned char* p = ring + slot * SLOT;
                mbar_expect(full + slot, (s < nt ? TILE : 2 * TILE) + REC * 4);
                tma_rows(p, &kmap, h, tile * BN, b, full + slot);
                if (s >= nt) tma_rows(p + TILE, &vmap, h, tile * BN, b, full + slot);
                bulk_copy(p + 2 * TILE, rec + ((size_t)pair * nt + tile) * REC, REC * 4,
                          full + slot);
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
    const int rw = 16 * warp;  // the warp's first row in the CTA's tile
    float* mrow = reinterpret_cast<float*>(scr + warp * SCRATCH);  // 16
    float* list = mrow + 16;                                        // LIST

    mbar_wait(qbar, 0);
    // the q fragments of rows g and g + 8 of the warp, and the rows' norms
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
        ldmatrix_x4(qa[kc], Qs + swz(rw + (mat & 1) * 8 + r8, 2 * kc + (mat >> 1)));
    float qn[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float lo = topk::bf16_lo(qa[kc][i]), hi = topk::bf16_hi(qa[kc][i]);
            qn[i & 1] = fmaf(lo, lo, fmaf(hi, hi, qn[i & 1]));
        }
    bool rowok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
        qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
        qn[r] = sqrtf(qn[r]);
        rowok[r] = q0 + rw + g + 8 * r < L;
    }

    // score i of the lane: column tile i / 4 (8 keys), row g + 8 ((i / 2) & 1),
    // key 8 (i / 4) + 2t + (i & 1) of the tile
    float sacc[SC];
    float oacc[DH / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < SC; ++i) sacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kc][e] = 0u;
    float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8: the exact maxima
    float ma[2] = {-INFINITY, -INFINITY};  // ... of the tensor-core scores so far
    float er[2] = {0.0f, 0.0f};            // ... and their largest bound
    float pm[2] = {0.0f, 0.0f};            // ... exp(-1e9 - m), a padded key's p
    float lsum[2] = {0.0f, 0.0f};
    // Sweep 1's flagged keys wait in the warp's list as codes (score index,
    // lane, tile) until the sweep's end, when settle takes their exact
    // scores from k in device memory, once, into the rows' maxima.
    int npend = 0;
    auto settle = [&](int n) {
        const int* codes = reinterpret_cast<const int*>(list);
        for (int i = lane; i < n; i += 32) {
            const int code = codes[i], pos = code & 0xFF, ln = (code >> 8) & 31, e = pos & 3;
            const int row = (ln >> 2) + 8 * (e >> 1);
            const int j = (code >> 13) * BN + (pos >> 2) * 8 + 2 * (ln & 3) + (e & 1);
            list[PEND + i] =
                exact_score_g(Qs, rw + row, kg + (((size_t)b * L + j) * H + h) * DH, scale);
        }
        __syncwarp();
        for (int i = 0; i < n; ++i) {
            const int code = codes[i], ln = (code >> 8) & 31;
            const int row = (ln >> 2) + 8 * ((code >> 1) & 1);
            if (row == g) m[0] = fmaxf(m[0], list[PEND + i]);
            if (row == g + 8) m[1] = fmaxf(m[1], list[PEND + i]);
        }
        __syncwarp();
    };

    auto release = [&](int slot) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
    };

    // The flagged scores of a tile (bit i % 32 of fl[i / 32]: the lane's
    // score i), recomputed by the warp's lanes from a list, 32 at a time:
    // the exact score (sweep 1) or exp(exact score - m) (sweep 2) of each.
    // Returns the lane's first entry of the list, where its flagged scores'
    // values follow in their order, or -1 if the warp flagged none.
    auto recompute = [&](const uint32_t (&fl)[SC / 32], const unsigned char* Ks, bool prob) {
        int cnt = 0;
#pragma unroll
        for (int hh = 0; hh < SC / 32; ++hh) cnt += __popc(fl[hh]);
        if (__ballot_sync(0xffffffffu, cnt != 0) == 0) return -1;
        int off = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, off, o);
            if (lane >= o) off += y;
        }
        const int total = __shfl_sync(0xffffffffu, off, 31);
        off -= cnt;
        int* codes = reinterpret_cast<int*>(list);
        int w = off;
#pragma unroll
        for (int hh = 0; hh < SC / 32; ++hh)
            for (uint32_t f = fl[hh]; f; f &= f - 1) codes[w++] = (32 * hh + __ffs(f) - 1) | (lane << 8);
        __syncwarp();
        for (int i = lane; i < total; i += 32) {
            const int code = codes[i], pos = code & 0xFF, ln = code >> 8, e = pos & 3;
            const int row = (ln >> 2) + 8 * (e >> 1), col = (pos >> 2) * 8 + 2 * (ln & 3) + (e & 1);
            const float sc = exact_score_sw(Qs, rw + row, Ks, col, scale);
            list[i] = prob ? expf(__fsub_rn(sc, mrow[row])) : sc;
        }
        __syncwarp();
        return off;
    };

    bool pend = false;  // pa holds a tile's p whose p v is not issued yet
    int pslot = 0;
    for (int s = 0; s <= steps; ++s) {
        const int slot = s % STAGES;
        const unsigned char* p = ring + slot * SLOT;
        if (s < steps) mbar_wait(full + slot, (s / STAGES) & 1);
        // the last tile's p v, then this tile's q k^T
        wgmma_fence();
        if (pend) {
            const unsigned char* Vs = ring + pslot * SLOT + TILE;
#pragma unroll
            for (int kc = 0; kc < BN / 16; ++kc) wgmma_pv(oacc, pa[kc], desc_v(Vs + kc * 16 * 128));
        }
        if (s < steps) {
#pragma unroll
            for (int kc = 0; kc < DH / 16; ++kc) wgmma_qk(sacc, qa[kc], desc_k(p + kc * 32), kc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        keep(sacc);
        keep(oacc);
        keep(pa);
        if (pend) release(pslot);
        pend = false;
        if (s == steps) break;

        const float* rc = reinterpret_cast<const float*>(p + 2 * TILE);
        const float kmax = rc[BN], nlive = rc[BN + 1], npad = rc[BN + 2];
        if (s < nt) {
            // sweep 1: the exact row maxima.  With ma the largest tensor-core
            // score of the row so far (this tile included) and er the largest
            // bound, the row's maximum key k* has sa(k*) + e(k*) >= s(k*) >=
            // ma - er; the keys that pass that test are flagged, and the
            // row's maximum is always among them.  A tile whose largest score
            // and bound cannot pass it flags none.
            if (npad > 0.0f) {  // a padded key scores -1e9 in every row
                m[0] = fmaxf(m[0], MASKED);
                m[1] = fmaxf(m[1], MASKED);
            }
            uint32_t fl[SC / 32] = {};
            bool cand = false;
            if (nlive > 0.0f) {
                float ta[2] = {-INFINITY, -INFINITY};
                if (nlive == (float)BN) {
#pragma unroll
                    for (int i = 0; i < SC; ++i) ta[(i >> 1) & 1] = fmaxf(ta[(i >> 1) & 1], sacc[i]);
                } else {
#pragma unroll
                    for (int n = 0; n < N / 8; ++n) {
                        const float2 c2 = *reinterpret_cast<const float2*>(rc + 8 * n + 2 * t);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if ((e & 1 ? c2.y : c2.x) >= 0.0f)
                                ta[e >> 1] = fmaxf(ta[e >> 1], sacc[4 * n + e]);
                    }
                }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    ta[r] = fmaxf(ta[r], __shfl_xor_sync(0xffffffffu, ta[r], 1));
                    ta[r] = fmaxf(ta[r], __shfl_xor_sync(0xffffffffu, ta[r], 2));
                    const float top = ta[r] * scale;
                    ma[r] = fmaxf(ma[r], top);
                    er[r] = fmaxf(er[r], kmax * qn[r]);
                    cand |= rowok[r] && fmaf(kmax, qn[r], top) >= ma[r] - er[r];
                }
                cand = __any_sync(0xffffffffu, cand);
                if (cand) {
#pragma unroll
                    for (int n = 0; n < N / 8; ++n) {
                        const float2 c2 = *reinterpret_cast<const float2*>(rc + 8 * n + 2 * t);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float kb = e & 1 ? c2.y : c2.x;
                            const int r = e >> 1, i = 4 * n + e;
                            if (kb >= 0.0f && rowok[r] &&
                                fmaf(kb, qn[r], sacc[i] * scale) >= ma[r] - er[r])
                                fl[i >> 5] |= 1u << (i & 31);
                        }
                    }
                }
            }
            if (cand) {
                // the flagged keys join the warp's list, settled at the
                // sweep's end (or now, when the list is full)
                int cnt = 0;
#pragma unroll
                for (int hh = 0; hh < SC / 32; ++hh) cnt += __popc(fl[hh]);
                int off = cnt;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int y = __shfl_up_sync(0xffffffffu, off, o);
                    if (lane >= o) off += y;
                }
                const int total = __shfl_sync(0xffffffffu, off, 31);
                if (npend + total > PEND) {
                    settle(npend);
                    npend = 0;
                }
                if (total > PEND) {  // more than the list holds: from the tile, now
                    int w = recompute(fl, p, false);
#pragma unroll
                    for (int i = 0; i < SC; ++i)
                        if (fl[i >> 5] & (1u << (i & 31)))
                            m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], list[w++]);
                    __syncwarp();  // the list is rewritten by the next tile
                } else {
                    int* codes = reinterpret_cast<int*>(list);
                    int w = npend + off - cnt;
#pragma unroll
                    for (int hh = 0; hh < SC / 32; ++hh)
                        for (uint32_t f = fl[hh]; f; f &= f - 1)
                            codes[w++] = (32 * hh + __ffs(f) - 1) | (lane << 8) | (s << 13);
                    npend += total;
                }
            }
            release(slot);
            if (s == nt - 1) {  // the rows' final maxima (four lanes a row)
                settle(npend);
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
                    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
                    pm[r] = expf(MASKED - m[r]);
                    if (t == 0) mrow[g + 8 * r] = m[r];
                }
                __syncwarp();
            }
        } else {
            // sweep 2: p = exp(s - m) in place of the scores.  A p whose f32
            // value lies within its uncertainty of a bf16 rounding midpoint
            // is flagged and recomputed from the exact score.  The uncertainty against the plain version's expf(s
            // - m), relative, is below |y| 2^-22 + c, y = (s - m) log2(e) as
            // formed here, c the score's bound (the tile's largest, or the
            // key's own in a tile with padding), 2^-20 for both
            // exponentials' errors, and |m| 2^-22 for the roundings of scale
            // log2(e) and m log2(e) (y's own rounding is in the first term);
            // c < 0: no test.
            float cm[2], cr[2], ym[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                cm[r] = rowok[r] ? fmaf(fabsf(m[r]), 0x1p-22f, 0x1p-20f) : -INFINITY;
                cr[r] = fmaf(kmax, qn[r], cm[r]);
                ym[r] = m[r] * -1.44269504f;
            }
            const float ys = scale * 1.44269504f;
            uint32_t fl[SC / 32] = {};
            // p of a live key: 2^y, and the bf16 rounding midpoint nearest it
            auto live_p = [&](int i, int r, float c) {
                const float y = fmaf(sacc[i], ys, ym[r]);
                const float pv = ex2_approx(y);
                const float mid = __uint_as_float(__byte_perm(__float_as_uint(pv), 0x8000u, 0x3254));
                if (fabsf(pv - mid) <= pv * fmaf(fabsf(y), 0x1p-22f, c)) fl[i >> 5] |= 1u << (i & 31);
                return pv;
            };
            if (npad == (float)BN) {  // every key padded
#pragma unroll
                for (int i = 0; i < SC; ++i) sacc[i] = pm[(i >> 1) & 1];
            } else if (nlive == (float)BN) {  // every key live: no masks
#pragma unroll
                for (int i = 0; i < SC; ++i) sacc[i] = live_p(i, (i >> 1) & 1, cr[(i >> 1) & 1]);
            } else {
#pragma unroll
                for (int n = 0; n < N / 8; ++n) {
                    const float2 c2 = *reinterpret_cast<const float2*>(rc + 8 * n + 2 * t);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float kb = e & 1 ? c2.y : c2.x;
                        const int r = e >> 1, i = 4 * n + e;
                        sacc[i] = kb >= 0.0f
                                      ? live_p(i, r, fmaf(kb, qn[r], cm[r]))
                                  : kb > -1.5f ? pm[r]
                                               : 0.0f;
                    }
                }
            }
            int w = recompute(fl, p, true);
            if (w >= 0) {
#pragma unroll
                for (int i = 0; i < SC; ++i)
                    if (fl[i >> 5] & (1u << (i & 31))) sacc[i] = list[w++];
                __syncwarp();  // the list is rewritten by the next tile
            }
            // summed unrounded, rounded to bf16 as the A fragments of p v
#pragma unroll
            for (int i = 0; i < SC; ++i) lsum[(i >> 1) & 1] += sacc[i];
#pragma unroll
            for (int kc = 0; kc < BN / 16; ++kc) {
                pa[kc][0] = pack_bf16(sacc[8 * kc + 0], sacc[8 * kc + 1]);
                pa[kc][1] = pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
                pa[kc][2] = pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
                pa[kc][3] = pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
            }
            pend = true;
            pslot = slot;
        }
    }

    const float extra = (float)(padded_length(L) - L);
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
        if (m[r] == MASKED) lsum[r] += extra;  // all keys padding
        den[r] = fmaxf(lsum[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + rw + g + 8 * r;
        if (row >= L) continue;
        uint16_t* o = out + (((size_t)b * L + row) * H + h) * DH;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
            *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
                pack_bf16(oacc[4 * n + 2 * r] / den[r], oacc[4 * n + 2 * r + 1] / den[r]);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the TMA descriptor of a (B, L, H, DH) bf16 tensor as (DH, H, L, B):
// boxes of ``rows`` positions of one head (rows x 128 bytes) in the
// 128-byte swizzle, zeros past L; cuTensorMapEncodeTiled is looked up at
// run time, so the library links nothing beyond the CUDA runtime
int rows_map(CUtensorMap* map, const void* x, int B, int L, int H, int rows) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return (int)err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorSymbolNotFound;
        encode = (EncodeTiled)fn;
    }
    const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)H * DH * 2,
                                   (cuuint64_t)L * H * DH * 2};
    const cuuint32_t box[4] = {DH, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// two launches: the key bounds into work (B H ceil(L / BN) REC floats),
// then the attention
int attend(const void* q, const void* k, const void* v, const void* pad, void* work, void* out,
           int B, int L, int H, float scale, cudaStream_t stream) {
    const int nt = (L + BN - 1) / BN, BH = B * H;
    key_bounds::mea_bf16_kernel<DH, BN, false><<<dim3(nt, BH), BN, 0, stream>>>(
        (const uint16_t*)k, (const float*)pad, (float*)work, L, H, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap maps[3];
    const void* src[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
        const int e = rows_map(&maps[i], src[i], B, L, H, i == 0 ? BM : BN);
        if (e != 0) return e;
    }
    auto kern = mea_bf16_kernel<DH, BN, false>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((L + BM - 1) / BM, BH), NT, SMEM, stream>>>(
        maps[0], maps[1], maps[2], (const uint16_t*)k, (const float*)work, (uint16_t*)out, L, H,
        scale);
    return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// q, k, v, out (B, L, H, dh) contiguous, bf16 (is_bf16 = 1) or f32; pad
// (B, L) f32, 1 = live key; scale = 1 / sqrt(dh).  dh % 8 == 0, dh <= 128,
// L >= 1, B * H <= 65535 (checked by the Python wrapper).  design 0: the
// tile template; 1: the Hopper design (bf16, dh 64 only), whose key bounds
// go to work, B H ceil(L / 128) 132 f32 values.  Returns the launch's
// cudaError_t.
extern "C" int mea_attention(const void* q, const void* k, const void* v, const void* pad,
                             int is_bf16, int B, int L, int H, int dh, float scale, int design,
                             void* work, void* out, void* stream) {
    if (design == 1) {
        if (!is_bf16 || dh != hopper::DH || work == nullptr) return (int)cudaErrorInvalidValue;
        return hopper::attend(q, k, v, pad, work, out, B, L, H, scale, (cudaStream_t)stream);
    }
    return attend<false>(q, k, v, pad, is_bf16, B, L, H, dh, scale, 0, out, stream);
}

// The same with the band |i - j| <= window (window >= 0): the window mode.
extern "C" int mea_attention_window(const void* q, const void* k, const void* v,
                                    const void* pad, int is_bf16, int B, int L, int H, int dh,
                                    float scale, int window, void* out, void* stream) {
    return attend<true>(q, k, v, pad, is_bf16, B, L, H, dh, scale, window, out, stream);
}
