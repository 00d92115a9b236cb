// binmax_int8: pass 1 of the int8 two-pass top-k on Hopper.
//
// Replaces modular_rag_system_tpu/ops/binmax_topk.py:_binmax_int8_kernel
// (via binmax_int8_call).  For int8 rows E_q (cap, d) with per-row scales
// and int8 queries q (Q, d) with per-query scales it writes
//
//     out[q, b] = max over rows r of bin b of  float(E_q[r] . q) * scale[r] * q_scale[q]
//
// as (Q, nb), nb = cap / bin_width.  The int8 products are summed in int32
// on the tensor cores, exactly in any order; the int32 -> f32 conversion is
// exact while d*127*127 < 2^24, and the two f32 multiplies round in the TPU
// kernel's order, so the result is bit-exact against the JAX kernel and the
// plain PyTorch version.
//
// Bound: the card must read cap*d bytes of rows once and do 2*cap*Q*d int8
// operations: at d 768 the row stream bounds it below Q ~ 295 queries (at
// the engine's Q = 256 the two bounds are within 15% of each other).  So a
// row tile must be read once for all queries, behind enough loads in
// flight, and multiplied on the int8 tensor cores.
//
// Design: persistent CTAs walk the 128-row tiles; the CTAs of all query
// tiles are resident at once and walk the same tiles together, so a row
// tile comes from device memory once.  A CTA loads its query tile (16,
// 64, 128 or 256 queries, by Q: the launch plan of ops/binmax_topk.py)
// into shared memory once and keeps it for its whole life: 256 queries at
// d 768 are 196,608 bytes, so no query streams from L2.  Row tiles arrive
// in k-steps of 128 rows x 128 bytes, each one tensor-memory-accelerator
// (TMA) box copied by one thread into a ring slot (6 slots, 2 beside 256
// queries) and signalled on the slot's mbarrier; the box lands in the
// 128-byte swizzle that wgmma reads, zero-filled past d and past cap.  (d
// or an address no multiple of 16: cp.async copies write the same layout.)
// One k-step sequence runs over all of a CTA's tiles, so the next tile's
// loads are in flight during this tile's epilogue.  Two warpgroups of 64
// rows run wgmma m64nNk32 s8 x s8 -> s32 with both operands read from
// shared memory by descriptor (the queries in the no-swizzle K-major
// layout: core matrices of 8 rows x 16 bytes, dense), so no register
// holds a row.  The epilogue dequantises in registers (float(acc) *
// scale[r], then * q_scale[q]; the row scales are read at the tile's
// first k-step), takes the bin max over the accumulators' rows by
// shuffles (a reduce-scatter at 64 queries and more: each of three rounds
// halves the values a lane holds), combines a bin's warps through the
// slot just read, and writes each query's bins of the tile as one
// contiguous run.
//
// What bounds it now (PERF.md section 6): at Q = 1 the row stream (TMA
// boxes; per-thread cp.async copies of the same ring held the stream near
// 1.8 TB/s whatever its depth); at Q = 256 the products and the ring: the
// query tile leaves room for two slots, one k-step in flight beside the
// one being multiplied.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;          // rows per tile: two warpgroups of 64
constexpr int NT = 256;          // 8 warps
constexpr int BK = 128;          // bytes of a row in a k-step: one 128-byte swizzle atom
constexpr int SLOT = BR * BK;    // bytes of a ring slot
constexpr int SMEM_MAX = 232448; // dynamic shared memory a CTA may use

// ring stages of each query-tile width: the query tile and the ring share
// the 227 KB of a CTA's shared memory (ops/binmax_topk.py
// _BINMAX_INT8_TILES holds the same table)
template <int BQ>
struct Cfg {
    static constexpr int STAGES = BQ == 256 ? 2 : 6;
    // the bin-max exchange (8 warps x BQ f32) reuses the slot of a tile's
    // last k-step
    static_assert(8 * BQ * 4 <= SLOT, "the exchange must fit a ring slot");
    // 1 KB to align the ring to the swizzle pattern, the ring, the queries,
    // their scales and a barrier per slot
    static size_t smem(int dpad) {
        return 1024 + (size_t)STAGES * SLOT + (size_t)BQ * dpad + BQ * 4 + STAGES * 8;
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared, zero-filled where !valid
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
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 16 bytes of ``row`` from byte k on (zeros past d or for a dead row)
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const int8_t* base,
                                           const int8_t* row, int k, int d, bool row_ok,
                                           bool vec16) {
    if (vec16) {
        const bool ok = row_ok && k < d;
        cp_async16(dst, ok ? row + k : base, ok);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool ok = row_ok && k + 4 * j < d;
            cp_async4(dst + 4 * j, ok ? row + k + 4 * j : base, ok);
        }
    }
}

// an mbarrier per ring slot: the tensor-memory-accelerator (TMA) copy of a
// slot completes its transaction bytes, the consumers wait on its phase
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// a (128 rows x 128 bytes) box of the rows at (k0, row0), 128-byte
// swizzled, zeros outside the matrix
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0, int row0,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(smem_addr(bar))
        : "memory");
}

// a wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart, chunk c of row r stored at c ^ (r % 8)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// a wgmma operand descriptor of a no-swizzle K-major tile: core matrices
// of 8 rows x 16 bytes, lbo bytes apart along K, sbo bytes apart along M/N
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

// D (64 x N, s32) += A (64 x 32, s8, descriptor da) x B (32 x N, s8,
// descriptor db); per thread the accumulators of mma.sync m16n8k32 for
// the warp's 16 rows, over N / 8 column tiles
__device__ __forceinline__ void wgmma_n16(int32_t (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int32_t (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int32_t (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(int32_t (&d)[N / 2], uint64_t da, uint64_t db) {
    if constexpr (N == 16) wgmma_n16(d, da, db);
    else if constexpr (N == 64) wgmma_n64(d, da, db);
    else if constexpr (N == 128) wgmma_n128(d, da, db);
    else wgmma_n256(d, da, db);
}

// one round of the bin max's reduce-scatter: the lane keeps the half of
// h[0, 2 HALF) that up selects and takes its partner's maxima of it
template <int HALF, int N>
__device__ __forceinline__ void reduce_scatter(float (&h)[N], int up, int mask) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const float send = up ? h[i] : h[i + HALF];
        const float keep = up ? h[i + HALF] : h[i];
        h[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
}

template <int BQ>
__global__ void __launch_bounds__(NT, 1)
binmax_int8_kernel(const __grid_constant__ CUtensorMap tmap, const int8_t* __restrict__ E,
                   const int8_t* __restrict__ qi, const float* __restrict__ scales,
                   const float* __restrict__ q_scale, int cap, int Q, int d, int dpad,
                   int bin_width, int nb, int ntiles, int tma, int vec16,
                   float* __restrict__ out) {
    using C = Cfg<BQ>;
    constexpr int V = BQ / 2;  // accumulators a thread holds
    extern __shared__ unsigned char smem[];
    unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);  // STAGES x SLOT
    unsigned char* Qs = ring + C::STAGES * SLOT;                               // BQ x dpad
    float* qsc = reinterpret_cast<float*>(Qs + (size_t)BQ * dpad);             // BQ
    uint64_t* bar = reinterpret_cast<uint64_t*>(qsc + BQ);                     // STAGES

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
    const int q0 = blockIdx.y * BQ;
    const int qchunks = dpad / 16;
    const int ks = dpad / BK;  // k-steps per tile
    const int mine = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int total = mine * ks;

    // the query tile, once: chunk c of query n at core matrix (n / 8, c)
    for (int i = tid; i < BQ * qchunks; i += NT) {
        const int n8 = i & 7, rest = i >> 3;
        const int c = rest % qchunks, n = (rest / qchunks) * 8 + n8;
        const bool ok = q0 + n < Q;
        copy_chunk(Qs + ((size_t)(n >> 3) * qchunks + c) * 128 + n8 * 16, qi,
                   ok ? qi + (size_t)(q0 + n) * d : qi, c * 16, d, ok, vec16);
    }
    for (int n = tid; n < BQ; n += NT) qsc[n] = q0 + n < Q ? q_scale[q0 + n] : 0.0f;
    if (tid == 0) {
        for (int st = 0; st < C::STAGES; ++st) mbar_init(bar + st);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a k-step of a row tile: one TMA box, or (d or an address no multiple
    // of 16) cp.async copies into the same swizzled layout, zeros past d
    // and past cap
    auto load = [&](int step) {
        unsigned char* slot = ring + (step % C::STAGES) * SLOT;
        const int row0 = ((int)blockIdx.x + (step / ks) * (int)gridDim.x) * BR;
        const int k0 = (step % ks) * BK;
        if (tma) {
            if (tid == 0) {
                mbar_expect(bar + step % C::STAGES, SLOT);
                tma_load(slot, &tmap, k0, row0, bar + step % C::STAGES);
            }
            return;
        }
        for (int i = tid; i < BR * 8; i += NT) {
            const int r = i >> 3, c = i & 7;
            const int row = row0 + r;
            const bool ok = row < cap;
            copy_chunk(slot + r * BK + ((c ^ (r & 7)) << 4), E, ok ? E + (size_t)row * d : E,
                       k0 + c * 16, d, ok, vec16);
        }
    };

    // the first group also carries the query tile
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
        if (s < total) load(s);
        cp_async_commit();
    }

    int32_t acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0;
    float sA = 0.0f, sB = 0.0f;  // the tile's row scales of this lane's two rows

    for (int step = 0; step < total; ++step) {
        cp_async_wait<C::STAGES - 2>();  // this step's slot has landed ...
        if (tma) mbar_wait(bar + step % C::STAGES, (step / C::STAGES) & 1);
        // (cp.async copies are generic-proxy writes; wgmma reads by the
        // async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // ... for every thread, and the slot loaded next
                          // was read by all
        if (step + C::STAGES - 1 < total) load(step + C::STAGES - 1);
        cp_async_commit();

        const int tile = (int)blockIdx.x + (step / ks) * (int)gridDim.x;
        const int rb = warp * 16;
        if (step % ks == 0) {  // read now, used at the tile's last k-step
            const int rA = tile * BR + rb + g;
            sA = rA < cap ? __ldg(scales + rA) : 0.0f;
            sB = rA + 8 < cap ? __ldg(scales + rA + 8) : 0.0f;
        }
        const unsigned char* slot = ring + (step % C::STAGES) * SLOT;
        const int kc = (step % ks) * (BK / 16);  // the k-step's first chunk of a query
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
            wgmma<BQ>(acc, sw128_desc(slot + wg * 64 * BK + kk * 32),
                      gmma_desc(Qs + (kc + kk * 2) * 128, 128, qchunks * 128));
        wgmma_commit();
        wgmma_wait_all();

        if (step % ks != ks - 1) continue;

        // the tile is done.  Accumulator i of a lane holds row
        // rb + g + 8 ((i >> 1) & 1), query 8 (i >> 2) + 2t + (i & 1).
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float rs = (i >> 1) & 1 ? sB : sA;
            const float qs = qsc[8 * (i >> 2) + 2 * t + (i & 1)];
            // float(acc) * row scale, then * query scale: the TPU order
            v[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), rs), qs);
            acc[i] = 0;
        }
        if (bin_width < 16) {
            // shuffles over the lane bits of g reduce each value over
            // bin_width rows; the lanes that head a bin write it
#pragma unroll
            for (int i = 0; i < V; ++i) {
                if (bin_width >= 2) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 4));
                if (bin_width >= 4) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 8));
                if (bin_width >= 8) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 16));
            }
            if (g % bin_width == 0) {
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const int gq = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
                    const int r = tile * BR + rb + g + 8 * ((i >> 1) & 1);
                    if (gq < Q && r < cap) out[(size_t)gq * nb + r / bin_width] = v[i];
                }
            }
            continue;
        }
        // bins of 16 rows or more: first the maxima over the warp's 16 rows
        // of each query (h[j]: query 8 (j >> 1) + 2t + (j & 1)), then a
        // bin's warps through shared memory, in this step's slot once both
        // warpgroups' products have read it
        float* red = reinterpret_cast<float*>(ring + (step % C::STAGES) * SLOT);
        constexpr int H = V / 2;
        float h[H];
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const int i = (j >> 1) * 4 + (j & 1);
            h[j] = fmaxf(v[i], v[i + 2]);
        }
        __syncthreads();
        if constexpr (H >= 8) {
            // three shuffle rounds, each halving the values a lane holds
            reduce_scatter<H / 2>(h, g & 1, 4);
            reduce_scatter<H / 4>(h, (g >> 1) & 1, 8);
            reduce_scatter<H / 8>(h, g >> 2, 16);
            // value i < H / 8 is h[i + (H / 2) g0 + (H / 4) g1 + (H / 8) g2]
            const int base = (H / 2) * (g & 1) + (H / 4) * ((g >> 1) & 1) + (H / 8) * (g >> 2);
#pragma unroll
            for (int i = 0; i < H / 8; ++i) {
                const int j = i + base;
                red[warp * BQ + 8 * (j >> 1) + 2 * t + (j & 1)] = h[i];
            }
        } else {
#pragma unroll
            for (int j = 0; j < H; ++j) {
                h[j] = fmaxf(h[j], __shfl_xor_sync(0xffffffffu, h[j], 4));
                h[j] = fmaxf(h[j], __shfl_xor_sync(0xffffffffu, h[j], 8));
                h[j] = fmaxf(h[j], __shfl_xor_sync(0xffffffffu, h[j], 16));
            }
            if (g == 0) {
#pragma unroll
                for (int j = 0; j < H; ++j) red[warp * BQ + 8 * (j >> 1) + 2 * t + (j & 1)] = h[j];
            }
        }
        __syncthreads();
        // consecutive threads take consecutive bins of one query: each
        // query's bins of the tile are one contiguous run of the output
        const int nbt = BR / bin_width, wpb = bin_width / 16;
        for (int o = tid; o < nbt * BQ; o += NT) {
            const int bl = o % nbt, qq = o / nbt;
            const int gb = tile * nbt + bl;
            if (q0 + qq >= Q || gb >= nb) continue;
            float mx = red[bl * wpb * BQ + qq];
            for (int w = 1; w < wpb; ++w) mx = fmaxf(mx, red[(bl * wpb + w) * BQ + qq]);
            out[(size_t)(q0 + qq) * nb + gb] = mx;
        }
        // the slot is loaded again (by the async proxy) only after the next
        // step's barrier
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    cp_async_wait<0>();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the TMA descriptor of the rows, E (cap, d) int8: boxes of 128 rows x 128
// bytes in the 128-byte swizzle; cuTensorMapEncodeTiled is looked up at run
// time, so the library links nothing beyond the CUDA runtime
int row_map(CUtensorMap* map, const void* E, int cap, int d) {
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
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)cap};
    const cuuint64_t strides[1] = {(cuuint64_t)d};
    const cuuint32_t box[2] = {BK, BR};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(E), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BQ>
int launch(const void* E, const void* q, const void* scales, const void* q_scale, int cap,
           int Q, int d, int bin_width, void* out, cudaStream_t stream) {
    using C = Cfg<BQ>;
    const int dpad = (d + BK - 1) / BK * BK;
    const size_t smem = C::smem(dpad);
    auto kern = binmax_int8_kernel<BQ>;
    cudaError_t err;
    static int sms = 0;  // set once: the limit, then the SM count
    if (sms == 0) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        int dev = 0, n = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        sms = n;
    }
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) !=
        cudaSuccess)
        return (int)err;
    // every CTA resident: the query tiles' CTAs walk the same row tiles
    // at the same time, so a row tile comes from device memory once and
    // from L2 for the other query tiles
    const int ntiles = (cap + BR - 1) / BR, qtiles = (Q + BQ - 1) / BQ;
    int per_qt = sms * (per_sm > 0 ? per_sm : 1) / qtiles;
    per_qt = per_qt < 1 ? 1 : (per_qt > ntiles ? ntiles : per_qt);
    const dim3 grid(per_qt, qtiles);
    const int vec16 = d % 16 == 0 && ((uintptr_t)E | (uintptr_t)q) % 16 == 0;
    // TMA boxes need 16-byte strides and address, and a matrix no smaller
    // than a box
    const int tma = vec16 && d >= BK && cap >= BR;
    CUtensorMap map = {};
    if (tma) {
        const int e = row_map(&map, E, cap, d);
        if (e != 0) return e;
    }
    kern<<<grid, NT, smem, stream>>>(map, (const int8_t*)E, (const int8_t*)q, (const float*)scales,
                                     (const float*)q_scale, cap, Q, d, dpad, bin_width,
                                     cap / bin_width, ntiles, tma, vec16, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// E_q (cap, d) int8, q_i8 (Q, d) int8, scales (cap,) f32, q_scale (Q,) f32,
// out (Q, cap / bin_width) f32; bq the query tile (16, 64, 128 or 256,
// from the wrapper's launch plan).  d % 4 == 0, 128 % bin_width == 0 and
// cap % bin_width == 0 (checked by the Python wrapper).  Returns the
// launch's cudaError_t.
extern "C" int binmax_int8(const void* E_q, const void* q_i8, const void* scales,
                           const void* q_scale, int cap, int Q, int d, int bin_width, int bq,
                           void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (bq) {
        case 16: return launch<16>(E_q, q_i8, scales, q_scale, cap, Q, d, bin_width, out, s);
        case 64: return launch<64>(E_q, q_i8, scales, q_scale, cap, Q, d, bin_width, out, s);
        case 128: return launch<128>(E_q, q_i8, scales, q_scale, cap, Q, d, bin_width, out, s);
        case 256: return launch<256>(E_q, q_i8, scales, q_scale, cap, Q, d, bin_width, out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
