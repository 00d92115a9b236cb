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

#include <cuda_bf16.h>

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

}  // namespace

// q, k, v, out (B, L, H, dh) contiguous, bf16 (is_bf16 = 1) or f32; pad
// (B, L) f32, 1 = live key; scale = 1 / sqrt(dh).  dh % 8 == 0, dh <= 128,
// L >= 1, B * H <= 65535 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int mea_attention(const void* q, const void* k, const void* v, const void* pad,
                             int is_bf16, int B, int L, int H, int dh, float scale, void* out,
                             void* stream) {
    return attend<false>(q, k, v, pad, is_bf16, B, L, H, dh, scale, 0, out, stream);
}

// The same with the band |i - j| <= window (window >= 0): the window mode.
extern "C" int mea_attention_window(const void* q, const void* k, const void* v,
                                    const void* pad, int is_bf16, int B, int L, int H, int dh,
                                    float scale, int window, void* out, void* stream) {
    return attend<true>(q, k, v, pad, is_bf16, B, L, H, dh, scale, window, out, stream);
}
