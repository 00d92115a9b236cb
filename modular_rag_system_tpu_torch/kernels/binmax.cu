// binmax: pass 1 of the two-pass top-k over f32 or bf16 rows on Hopper.
//
// Replaces modular_rag_system_tpu/ops/binmax_topk.py:_binmax_kernel (via
// binmax_call).  For rows E (cap, d), f32 or bf16, and queries q (Q, d)
// given as bf16, it writes
//
//     out[q, b] = max over rows r of bin b of  bf16(q) . bf16(E[r])
//
// as (Q, nb), nb = cap / bin_width: the TPU kernel's default-precision
// products (bf16 x bf16, exact) summed in f32.  An f32 row is rounded to
// bf16 (ties to even) as it is staged into shared memory.
//
// Bound: the card must read cap*d*4 (f32) or cap*d*2 (bf16) bytes once and
// do 2*cap*Q*d bf16 operations: the row stream bounds it below Q ~ 590
// (f32 rows) or ~ 295 (bf16 rows) queries.  Design: each CTA tiles 128
// rows x 64 queries; 32-wide k-steps are staged through shared memory as
// bf16 (rows padded to 40 values, so the fragment loads are free of bank
// conflicts), and eight warps, each a 32 x 32 tile, run mma.sync
// m16n8k16 bf16 products with f32 accumulators.  The query tiles of a row
// tile are consecutive CTAs, so a row tile is read from HBM about once.
// The score tile then goes through shared memory for the per-bin max
// (bins divide 128 rows).  The loads are synchronous and single-buffered:
// a cp.async/TMA ring and wgmma are the way to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;      // rows per CTA
constexpr int BQ = 64;       // queries per CTA
constexpr int BK = 32;       // depth of a k-step
constexpr int LDS = BK + 8;  // bf16 values per staged row (80 bytes)
constexpr int NT = 256;      // 8 warps: 4 over rows x 2 over queries
constexpr int SMEM = BR * (BQ + 1) * 4;  // the score tile; the k-step tiles alias it
static_assert(SMEM >= (BR + BQ) * LDS * 2, "staging tiles must fit the score tile");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
binmax_kernel(const void* __restrict__ Ev, const uint16_t* __restrict__ qb, int Q, int d,
              int bin_width, int nb, float* __restrict__ out) {
    __shared__ __align__(16) unsigned char smem[SMEM];
    uint16_t(*As)[LDS] = reinterpret_cast<uint16_t(*)[LDS]>(smem);
    uint16_t(*Bs)[LDS] = reinterpret_cast<uint16_t(*)[LDS]>(smem + BR * LDS * 2);
    float(*V)[BQ + 1] = reinterpret_cast<float(*)[BQ + 1]>(smem);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
    const int wm = warp & 3, wn = warp >> 2;
    // query tiles vary fastest, so the CTAs that share a row tile run
    // together and read it from HBM once (the others hit L2)
    const int nqt = (Q + BQ - 1) / BQ;
    const size_t row0 = (size_t)(blockIdx.x / nqt) * BR;
    const int q0 = (blockIdx.x % nqt) * BQ;

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
        if (BF16) {
            const uint16_t* E = (const uint16_t*)Ev;
            for (int i = tid; i < BR * BK / 8; i += NT) {
                const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (k0 + c < d) v = *(const uint4*)(E + (row0 + r) * d + k0 + c);
                *(uint4*)&As[r][c] = v;
            }
        } else {
            const float* E = (const float*)Ev;
            for (int i = tid; i < BR * BK / 4; i += NT) {
                const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (k0 + c < d) v = *(const float4*)(E + (row0 + r) * d + k0 + c);
                *(uint2*)&As[r][c] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
            }
        }
        for (int i = tid; i < BQ * BK / 8; i += NT) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (q0 + r < Q && k0 + c < d)
                v = *(const uint4*)(qb + (size_t)(q0 + r) * d + k0 + c);
            *(uint4*)&Bs[r][c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int rb = wm * 32 + mi * 16;
                a[mi][0] = *(const uint32_t*)&As[rb + g][kk + 2 * t];
                a[mi][1] = *(const uint32_t*)&As[rb + g + 8][kk + 2 * t];
                a[mi][2] = *(const uint32_t*)&As[rb + g][kk + 2 * t + 8];
                a[mi][3] = *(const uint32_t*)&As[rb + g + 8][kk + 2 * t + 8];
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int cb = wn * 32 + ni * 8;
                b[ni][0] = *(const uint32_t*)&Bs[cb + g][kk + 2 * t];
                b[ni][1] = *(const uint32_t*)&Bs[cb + g][kk + 2 * t + 8];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
    }

    // the score tile (rows x queries) overwrites the staging tiles: the
    // loop's last barrier ordered every read of them before this
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int r = wm * 32 + mi * 16 + g, c = wn * 32 + ni * 8 + 2 * t;
            V[r][c] = acc[mi][ni][0];
            V[r][c + 1] = acc[mi][ni][1];
            V[r + 8][c] = acc[mi][ni][2];
            V[r + 8][c + 1] = acc[mi][ni][3];
        }
    __syncthreads();

    // per-bin max; consecutive threads take consecutive bins of one query
    const int nbt = BR / bin_width;
    const int b0 = (int)(row0 / bin_width);
    for (int o = tid; o < nbt * BQ; o += NT) {
        const int bl = o % nbt, qq = o / nbt;
        const int gq = q0 + qq;
        if (gq >= Q) continue;
        const float* col = &V[bl * bin_width][qq];
        float m = col[0];
        for (int r = 1; r < bin_width; ++r) m = fmaxf(m, col[r * (BQ + 1)]);
        out[(size_t)gq * nb + b0 + bl] = m;
    }
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), q_bf16 (Q, d) bf16
// bits, out (Q, cap / bin_width) f32.  d % 8 == 0, cap % 128 == 0 and
// 128 % bin_width == 0 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int binmax(const void* E, int is_bf16, const void* q_bf16, int cap, int Q, int d,
                      int bin_width, void* out, void* stream) {
    const unsigned grid = (unsigned)(cap / BR) * ((Q + BQ - 1) / BQ);
    const cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        binmax_kernel<true><<<grid, NT, 0, s>>>(E, (const uint16_t*)q_bf16, Q, d, bin_width,
                                                cap / bin_width, (float*)out);
    else
        binmax_kernel<false><<<grid, NT, 0, s>>>(E, (const uint16_t*)q_bf16, Q, d, bin_width,
                                                 cap / bin_width, (float*)out);
    return (int)cudaGetLastError();
}
