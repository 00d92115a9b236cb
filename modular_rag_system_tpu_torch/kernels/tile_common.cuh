// Shared device code of the kernels that score rows on the tensor cores
// and select per query (fused_topk.cu, fine_topk.cu): cp.async copies,
// ldmatrix and mma.sync m16n8k16 bf16 -> f32, the exact widening of int8
// pairs to bf16, and the warp's selection and sort of 64-bit (score, id)
// keys (topk_common.cuh).

#pragma once

#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace tile {

using topk::EMPTY;
typedef unsigned long long u64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// the k smallest (k <= 32) of the warp's keys, N a lane: each lane sorts
// its N in registers, then k rounds of a warp minimum each take the
// smallest head; lane r returns the r-th smallest.  Keys are unique but
// for EMPTY, or with DUPS a key may repeat: then each round pops the head
// of one lane only, so every copy is returned.
template <int N, bool DUPS = false>
__device__ __forceinline__ u64 warp_select(u64 (&v)[N], int k, int lane) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = i & 1; j + 1 < N; j += 2) {
            const u64 a = v[j], b = v[j + 1];
            v[j] = kmin(a, b);
            v[j + 1] = a < b ? b : a;
        }
    u64 mine = EMPTY;
    for (int r = 0; r < k; ++r) {
        u64 m = v[0];
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) m = kmin(m, __shfl_xor_sync(0xffffffffu, m, sh));
        if (m == EMPTY) break;
        if (lane == r) mine = m;
        bool pop = v[0] == m;
        if (DUPS) pop = lane == __ffs(__ballot_sync(0xffffffffu, pop)) - 1;
        if (pop) {
#pragma unroll
            for (int j = 0; j + 1 < N; ++j) v[j] = v[j + 1];
            v[N - 1] = EMPTY;
        }
    }
    return mine;
}

// ascending sort of T (a power of two) keys by the 32 lanes of one warp
__device__ void warp_sort(u64* keys, int T, int lane) {
    for (int size = 2; size <= T; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = lane; i < T / 2; i += 32) {
                const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const u64 a = keys[lo], b = keys[hi];
                if ((a > b) == up) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
            __syncwarp();
        }
    }
}

// widens the two int8 values in the low 16 bits of w (the lower column
// in the low byte) to a bf16 pair, exactly
__device__ __forceinline__ uint32_t int8x2_bf16(uint32_t w) {
    return pack_bf16(topk::int8_to_float((int32_t)w, 0), topk::int8_to_float((int32_t)w, 1));
}

}  // namespace tile
