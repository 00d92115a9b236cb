// Shared device code of the fine-stage kernels that score a slab on the
// tensor cores (fine_topk.cu, fine_binmax.cu): the TMA ring of k-steps
// (a box of the slab's stored rows x 64 bytes in the 64-byte swizzle, an
// mbarrier per ring slot), one k-step's mma.sync m16n8k16 bf16 -> f32
// scores of the slab's 256 logical rows against up to 8 NJ query columns
// with, from the same fragments with their sign bits cleared, each
// score's sum of |q_i x_i|, and the exact rescore of chosen rows with
// fine_scores' own arithmetic (fine_common.cuh's dot_rows).
//
// The tensor cores sum in another order than fine_scores' lanes, so a
// tensor-core score s only bounds the row's fine_scores score: within
// e = ERR sum |q_i x_i| (both sums round far less at d <= 1024).  A kernel
// that must return fine_scores' values bit for bit uses s and e to pick
// the rows that can matter and scores only those again with
// score_any_rows.

#pragma once

#include <cuda.h>

#include "fine_common.cuh"
#include "tile_common.cuh"

namespace ftile {

using tile::smem_addr;

// a k-step: 32 bf16 or 64 int8 / packed int4 values, 64 bytes of each
// stored row
template <int MODE>
__host__ __device__ constexpr int kstep_values() { return MODE == fine::BF16 ? 32 : 64; }

// bytes of a k-step's TMA box: the slab's stored rows x 64 bytes
template <int MODE>
__host__ __device__ constexpr int slot_bytes() { return fine::stored_slab<MODE>() * 64; }

// the sign bits of a bf16 pair cleared: the magnitudes
constexpr uint32_t ABS2 = 0x7FFF7FFFu;
// the bound of |tensor-core sum - fine_scores sum| as a multiple of
// sum |q_i x_i| (the two sums' rounding is below 2^-16 of it at d <= 1024)
constexpr float ERR = 1.0f / 16384.0f;

// the dots of N stored rows p[j] of a slab (-1: none) with fine_scores'
// own arithmetic: fine_common.cuh's dot_rows on rows that need not be
// consecutive; int4 rows give the high-nibble row's dot in hi and the low
// one's in lo
template <int MODE, int N>
__device__ __forceinline__ void score_any_rows(const uint4* __restrict__ slab, int nvec,
                                               const int (&p)[N], const float* qs, int lane,
                                               float (&hi)[N], float (&lo)[N]) {
    uint4 v[N][fine::lane_vectors<MODE>()];
#pragma unroll
    for (int i = 0; i < fine::lane_vectors<MODE>(); ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int vi = lane + 32 * i;
            v[j][i] = vi < nvec && p[j] >= 0 ? slab[(size_t)p[j] * nvec + vi]
                                             : make_uint4(0, 0, 0, 0);
        }
    float acc[fine::outputs<MODE, N>()];
    fine::dot_rows<MODE, N>(v, nvec, qs, lane, acc);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        hi[j] = acc[j];
        lo[j] = MODE == fine::INT4 ? acc[N + j] : 0.0f;
    }
}

// the 16-byte chunk c of row r of a k-step's box as TMA stores it: rows of
// 64 bytes in the 64-byte swizzle (chunk c ^ (r / 2 % 4)), so the 8 rows an
// ldmatrix or a fragment load reads fall in distinct banks
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// an mbarrier per ring slot: the slot's TMA box completes its bytes on it
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}
// the (SR rows x 64 bytes) box of the rows at (k0, row0), zeros past d
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int k0, int row0,
                                        uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(smem_addr(bar))
        : "memory");
}

// the high (or low) nibbles of the two bytes of w (the low byte the lower
// column), each a 4-bit two's complement value, as a bf16 pair, exactly:
// nibble u biased by 8 becomes the mantissa of the bf16 128 + u (0x4300 |
// u), and one bf16 subtract of 136 leaves the value
template <bool HIGH>
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t w) {
    uint32_t y = __byte_perm(w, 0, 0x4140);  // the bytes at bits 0 and 16
    y = ((HIGH ? y >> 4 : y) & 0x000F000Fu) ^ 0x43084308u;
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y), __floats2bfloat162_rn(136.f, 136.f));
    return *reinterpret_cast<const uint32_t*>(&r);
}

// one k-step of a slab, the box in ``slot``: warp ``warp`` adds the
// products of its two A tiles (bf16 and int8: logical rows 32 warp + 16 m
// + [0, 16); int4: stored rows 16 warp + [0, 16), high nibbles in tile 0,
// low in tile 1) with column tile j, whose column g reads row cq[j] of the
// bf16 query tile Qs (-1: a zero column), into acc, and of the same
// fragments with their sign bits cleared into acc_abs; kq is the k-step's
// first value
template <int MODE, int NJ>
__device__ __forceinline__ void score_kstep(const unsigned char* slot, const uint16_t* Qs, int LDQ,
                                            const int (&cq)[NJ], int kq, int warp, int lane,
                                            float (&acc)[2][NJ][4], float (&acc_abs)[2][NJ][4]) {
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kstep_values<MODE>() / 16; ++kk) {
        uint32_t a[2][4];
        if (MODE == fine::BF16) {
            // rows of 64 bytes: 16-byte chunk kk * 2 + (mat >> 1)
#pragma unroll
            for (int m = 0; m < 2; ++m)
                tile::ldmatrix_x4(a[m], slot + swz(32 * warp + 16 * m + (mat & 1) * 8 + r8,
                                                   kk * 2 + (mat >> 1)));
        } else {
            // the byte pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of chunk kk
            // of rows r and r + 8
            auto pair = [&](int r, int h) {
                return (uint32_t)*reinterpret_cast<const uint16_t*>(slot + swz(r, kk) + 2 * t +
                                                                    8 * h);
            };
            if (MODE == fine::INT8) {
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int r = 32 * warp + 16 * m + g;
                    a[m][0] = tile::int8x2_bf16(pair(r, 0));
                    a[m][1] = tile::int8x2_bf16(pair(r + 8, 0));
                    a[m][2] = tile::int8x2_bf16(pair(r, 1));
                    a[m][3] = tile::int8x2_bf16(pair(r + 8, 1));
                }
            } else {
                // one stored row tile: high nibbles -> A tile 0 (logical rows
                // r), low nibbles -> A tile 1 (rows r + 128)
                const int r = 16 * warp + g;
                const uint32_t w[4] = {pair(r, 0), pair(r + 8, 0), pair(r, 1), pair(r + 8, 1)};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    a[0][e] = nib2_bf16<true>(w[e]);
                    a[1][e] = nib2_bf16<false>(w[e]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            uint32_t b0 = 0, b1 = 0;
            if (cq[j] >= 0) {
                const uint16_t* qp = Qs + (size_t)cq[j] * LDQ + kq + kk * 16 + 2 * t;
                b0 = *reinterpret_cast<const uint32_t*>(qp);
                b1 = *reinterpret_cast<const uint32_t*>(qp + 8);
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                tile::mma_bf16(acc[m][j], a[m], b0, b1);
                const uint32_t aa[4] = {a[m][0] & ABS2, a[m][1] & ABS2, a[m][2] & ABS2,
                                        a[m][3] & ABS2};
                tile::mma_bf16(acc_abs[m][j], aa, b0 & ABS2, b1 & ABS2);
            }
        }
    }
}

// the logical row of accumulators 2h and 2h + 1 of A tile m in warp
// ``warp``'s lane with group g (lane / 4)
template <int MODE>
__device__ __forceinline__ int acc_row(int warp, int m, int g, int h) {
    return MODE == fine::INT4 ? 16 * warp + 128 * m + g + 8 * h : 32 * warp + 16 * m + g + 8 * h;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the TMA descriptor of the fine copy as (nb SR) rows of d values: boxes
// of SR rows x 64 bytes, swizzled as swz() reads them;
// cuTensorMapEncodeTiled is looked up at run time, so the library links
// nothing beyond the CUDA runtime
template <int MODE>
int slab_map(CUtensorMap* map, const void* E, int nb, int d) {
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
    constexpr int SR = fine::stored_slab<MODE>();
    const bool bf16 = MODE == fine::BF16;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)nb * SR};
    const cuuint64_t strides[1] = {(cuuint64_t)d * (bf16 ? 2 : 1)};
    const cuuint32_t box[2] = {bf16 ? 32u : 64u, SR};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(
        map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
        const_cast<void*>(E), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace ftile
