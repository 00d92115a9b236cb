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
// bf16 (ties to even, cvt.rn.bf16x2.f32) as its fragments are formed.
//
// Bound: the card must read cap*d*4 (f32) or cap*d*2 (bf16) bytes once and
// do 2*cap*Q*d bf16 operations: the row stream bounds it below Q ~ 590
// (f32 rows) or ~ 295 (bf16 rows) queries.  A k-step loaded
// synchronously exposes the latency of device memory; a row tile staged
// once per query tile is read several times.
//
// Design: persistent CTAs (as many as fit on the SMs) walk the 128-row
// tiles; each CTA holds up to 256 queries, the engine's largest batch, so
// a row tile is read from device memory once (more queries: one more grid
// row per 256, whose CTAs walk the same tiles at the same time and find
// them in L2).  Rows and queries move as 16-byte cp.async copies into a
// three-stage ring of 64-deep k-steps, one k-step sequence over all of a
// CTA's tiles, so the next tile's first loads are in flight during this
// tile's bin-max epilogue.  Two warpgroups, 64 rows each, run wgmma
// m64nNk16 (N = 16, 64, 128 or 256 queries, by Q) with the rows as A in
// registers and the queries as B in shared memory, f32 accumulators: f32
// rows are staged as f32 and rounded to bf16 as their A fragments are
// formed (no bf16 copy of the rows in shared memory), bf16 rows are read
// into A by ldmatrix from rows padded by 16 bytes (free of bank
// conflicts); the query tile is stored in wgmma's no-swizzle K-major
// layout (8 x 16-byte core matrices, each 128 contiguous bytes), so the
// hardware reads each once per warpgroup.  The query slice of a k-step is
// as many bytes as the row slice at 256 queries (f32 rows): 256 queries
// are 393 KB, more than a CTA's shared memory, so L2 serves them.  The bin
// max reduces the accumulators over the rows: a reduce-scatter of
// shuffles within a warp gives each lane the maxima of its share of the
// 8-row groups (three rounds, each halving the values a lane holds), and
// shared memory combines the groups of a bin; bins of 1-4 rows are
// written from the shuffles.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W) over
// 8,388,608 rows of d 768, bins of 64: f32 rows 23.0546 ms at Q = 256 and
// 8.7102 ms at Q = 1 (bounds 7.7327 and 7.6926 ms by bytes), bf16 rows
// 20.1459 and 4.8587 ms (bounds 3.8864 and 3.8464 ms).  At Q = 256 the
// query stream from L2 and the 256-query configuration's registers (it
// spills at 255) hold it back; at Q = 1 the row stream does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;         // rows per tile: two warpgroups of 64
constexpr int BK = 64;          // depth of a k-step (128 bytes of an f32 row)
constexpr int STAGES = 3;       // ring slots
constexpr int NT = 256;         // 8 warps
constexpr int LDH = BK + 8;     // bf16 values per staged bf16 row (144 bytes)
constexpr int LDF = BK + 8;     // f32 values per staged f32 row (288 bytes)
constexpr int GROUPS = BR / 8;  // 8-row groups of a tile

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// a wgmma operand descriptor of a no-swizzle K-major tile: core matrices
// of 8 rows x 16 bytes, lbo bytes apart along K, sbo bytes apart along N
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x N, f32) += A (64 x 16, bf16 fragments in registers) x B (the
// descriptor's 16 x N); the accumulators and A per thread as in mma.sync
// m16n8k16 for the warp's 16 rows, over N / 8 column tiles
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
    if constexpr (N == 16) wgmma_n16(d, a, desc);
    else if constexpr (N == 64) wgmma_n64(d, a, desc);
    else if constexpr (N == 128) wgmma_n128(d, a, desc);
    else wgmma_n256(d, a, desc);
}

// one round of the bin max's reduce-scatter: the lane keeps the half of
// acc[0, 2 HALF) that up selects and takes its partner's maxima of it
template <int HALF, int N>
__device__ __forceinline__ void reduce_scatter(float (&acc)[N], int up, int mask) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const float send = up ? acc[i] : acc[i + HALF];
        const float keep = up ? acc[i + HALF] : acc[i];
        acc[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
}

template <bool BF16, int BQ>
struct Cfg {
    static constexpr int ROW_BYTES = BF16 ? BR * LDH * 2 : BR * LDF * 4;
    static constexpr int SLOT = ROW_BYTES + BQ * BK * 2;
    static constexpr int SMEM = STAGES * SLOT + GROUPS * BQ * 4;
};

template <bool BF16, int BQ>
__global__ void __launch_bounds__(NT, 1)
binmax_kernel(const void* __restrict__ Ev, const uint16_t* __restrict__ qb, int Q, int d,
              int bin_width, int nb, int ntiles, float* __restrict__ out) {
    using C = Cfg<BF16, BQ>;
    constexpr int NI = BQ / 8;  // 8-query column tiles of the accumulators
    extern __shared__ __align__(128) unsigned char smem[];
    float* red = reinterpret_cast<float*>(smem + STAGES * C::SLOT);  // GROUPS x BQ

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
    const int rb = warp * 16;  // this warp's 16 rows of the tile
    const int q0 = blockIdx.y * BQ;
    const int ks = (d + BK - 1) / BK;  // k-steps per tile
    const int mine = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int total = mine * ks;

    auto load = [&](int step) {
        unsigned char* slot = smem + (step % STAGES) * C::SLOT;
        const size_t row0 = (size_t)(blockIdx.x + (step / ks) * gridDim.x) * BR;
        const int k0 = (step % ks) * BK;
        if (BF16) {
            const uint16_t* E = (const uint16_t*)Ev;
            uint16_t* As = (uint16_t*)slot;
            for (int i = tid; i < BR * BK / 8; i += NT) {
                const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
                const bool ok = k0 + c < d;
                cp_async16(As + r * LDH + c, E + (ok ? (row0 + r) * d + k0 + c : 0), ok);
            }
        } else {
            const float* E = (const float*)Ev;
            float* As = (float*)slot;
            for (int i = tid; i < BR * BK / 4; i += NT) {
                const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
                const bool ok = k0 + c < d;
                cp_async16(As + r * LDF + c, E + (ok ? (row0 + r) * d + k0 + c : 0), ok);
            }
        }
        // queries as core matrices: query n, values 8c..8c+7 of the k-step
        unsigned char* Bs = slot + C::ROW_BYTES;
        for (int i = tid; i < BQ * BK / 8; i += NT) {
            const int n = i / (BK / 8), c = i % (BK / 8);
            const bool ok = q0 + n < Q && k0 + c * 8 < d;
            cp_async16(Bs + ((n >> 3) * (BK / 8) + c) * 128 + (n & 7) * 16,
                       qb + (ok ? (size_t)(q0 + n) * d + k0 + c * 8 : 0), ok);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < total) load(s);
        cp_async_commit();
    }

    float acc[NI * 4];
#pragma unroll
    for (int i = 0; i < NI * 4; ++i) acc[i] = 0.0f;

    for (int step = 0; step < total; ++step) {
        cp_async_wait<STAGES - 2>();  // this step's slot has landed
        // the copies were generic-proxy writes; wgmma reads by the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // ... for every thread, and the slot loaded next
                          // was read by all
        if (step + STAGES - 1 < total) load(step + STAGES - 1);
        cp_async_commit();

        // two k16 products at a time (their A fragments live until they
        // complete): 8 registers beside the accumulators
        const unsigned char* slot = smem + (step % STAGES) * C::SLOT;
        const unsigned char* Bs = slot + C::ROW_BYTES;
#pragma unroll
        for (int k2 = 0; k2 < BK / 16; k2 += 2) {
            uint32_t a[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kk = k2 + h;
                if (BF16) {
                    const uint16_t* As = (const uint16_t*)slot;
                    ldmatrix_x4(a[h], As + (rb + (mat & 1) * 8 + r8) * LDH + kk * 16 +
                                          (mat >> 1) * 8);
                } else {
                    const float* As = (const float*)slot + kk * 16 + 2 * t;
                    const float2 x0 = *(const float2*)(As + (rb + g) * LDF);
                    const float2 x1 = *(const float2*)(As + (rb + g + 8) * LDF);
                    const float2 x2 = *(const float2*)(As + (rb + g) * LDF + 8);
                    const float2 x3 = *(const float2*)(As + (rb + g + 8) * LDF + 8);
                    a[h][0] = pack_bf16(x0.x, x0.y);
                    a[h][1] = pack_bf16(x1.x, x1.y);
                    a[h][2] = pack_bf16(x2.x, x2.y);
                    a[h][3] = pack_bf16(x3.x, x3.y);
                }
            }
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h)
                wgmma<BQ>(acc, a[h], gmma_desc(Bs + (k2 + h) * 2 * 128, 128, (BK / 8) * 128));
            wgmma_commit();
            wgmma_wait_all();
        }

        if (step % ks != ks - 1) continue;

        // the tile is done: its bin maxima.  Accumulator i of a lane holds
        // row rb + g + 8 ((i >> 1) & 1), query 8 (i >> 2) + 2t + (i & 1).
        const int tile = blockIdx.x + (step / ks) * gridDim.x;
        if (bin_width < 8) {
            // shuffles over the lane bits of g reduce each accumulator over
            // bin_width rows; the lanes that head a bin write it
#pragma unroll
            for (int i = 0; i < NI * 4; ++i) {
                if (bin_width >= 2) acc[i] = fmaxf(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], 4));
                if (bin_width >= 4) acc[i] = fmaxf(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], 8));
            }
            if (g % bin_width == 0) {
#pragma unroll
                for (int i = 0; i < NI * 4; ++i) {
                    const int gq = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
                    const int r = rb + g + 8 * ((i >> 1) & 1);
                    if (gq < Q)
                        out[(size_t)gq * nb + ((size_t)tile * BR + r) / bin_width] = acc[i];
                }
            }
        } else {
            // the maxima over the 8 rows of g, reduce-scattered: each of
            // three shuffle rounds halves a lane's values (it keeps the
            // half its g bit selects and takes the partner's maxima of
            // it), so each lane ends with V / 8 distinct group maxima
            constexpr int V = NI * 4;
            reduce_scatter<V / 2>(acc, g & 1, 4);
            reduce_scatter<V / 4>(acc, (g >> 1) & 1, 8);
            reduce_scatter<V / 8>(acc, g >> 2, 16);
            // value i < V / 8 is accumulator i + (V / 2) g0 + (V / 4) g1 + (V / 8) g2
            const int base = (V / 2) * (g & 1) + (V / 4) * ((g >> 1) & 1) + (V / 8) * (g >> 2);
#pragma unroll
            for (int i = 0; i < V / 8; ++i) {
                const int j = i + base;
                red[(warp * 2 + ((j >> 1) & 1)) * BQ + 8 * (j >> 2) + 2 * t + (j & 1)] = acc[i];
            }
            __syncthreads();
            // consecutive threads take consecutive bins of one query
            const int nbt = BR / bin_width, gpb = bin_width / 8;
            for (int o = tid; o < nbt * BQ; o += NT) {
                const int bl = o % nbt, qq = o / nbt;
                if (q0 + qq >= Q) continue;
                float mx = red[bl * gpb * BQ + qq];
                for (int j = 1; j < gpb; ++j) mx = fmaxf(mx, red[(bl * gpb + j) * BQ + qq]);
                out[(size_t)(q0 + qq) * nb + (size_t)tile * nbt + bl] = mx;
            }
            // red is written again only after the next step's barrier
        }
#pragma unroll
        for (int i = 0; i < NI * 4; ++i) acc[i] = 0.0f;
    }
    cp_async_wait<0>();
}

template <bool BF16, int BQ>
int launch(const void* E, const void* q, int cap, int Q, int d, int bin_width, void* out,
           cudaStream_t stream) {
    using C = Cfg<BF16, BQ>;
    auto kern = binmax_kernel<BF16, BQ>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, C::SMEM)) !=
        cudaSuccess)
        return (int)err;
    const int ntiles = cap / BR;
    const int persistent = sms * (per_sm > 0 ? per_sm : 1);
    const dim3 grid(ntiles < persistent ? ntiles : persistent, (Q + BQ - 1) / BQ);
    kern<<<grid, NT, C::SMEM, stream>>>(E, (const uint16_t*)q, Q, d, bin_width,
                                        cap / bin_width, ntiles, (float*)out);
    return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* E, const void* q, int cap, int Q, int d, int bin_width, void* out,
             cudaStream_t s) {
    if (Q <= 16) return launch<BF16, 16>(E, q, cap, Q, d, bin_width, out, s);
    if (Q <= 64) return launch<BF16, 64>(E, q, cap, Q, d, bin_width, out, s);
    if (Q <= 128) return launch<BF16, 128>(E, q, cap, Q, d, bin_width, out, s);
    return launch<BF16, 256>(E, q, cap, Q, d, bin_width, out, s);
}

}  // namespace

// E (cap, d) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), q_bf16 (Q, d) bf16
// bits, out (Q, cap / bin_width) f32.  d % 8 == 0, cap % 128 == 0 and
// 128 % bin_width == 0 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int binmax(const void* E, int is_bf16, const void* q_bf16, int cap, int Q, int d,
                      int bin_width, void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) return dispatch<true>(E, q_bf16, cap, Q, d, bin_width, out, s);
    return dispatch<false>(E, q_bf16, cap, Q, d, bin_width, out, s);
}
