// moe_grouped: the SwiGLU GEMMs of the DeepSeek-V3 expert layer
// (models/deepseek_v3.py) as grouped Hopper GEMMs.
//
// Replaces no TPU kernel: the JAX package has no expert layer.  Added for
// the port's Moonlight-16B-A3B encoder, whose routed experts ran as a
// per-expert loop of library GEMMs behind a read-back of the experts' row
// counts (one pipeline drain and ~450 launches a layer), with SwiGLU's f32
// passes over the (rows, 2 width) gate/up product in device memory.
//
// Two entry points, one kernel template (moe_grouped_kernel<SWIGLU>):
//
//   moe_gate_up: act[r] = bf16(silu(g) * u), g and u the bf16 roundings of
//     the f32 sums x[r] . w13[e][c] and x[r] . w13[e][D + c], for the rows r
//     of group e (offsets[e] <= r < offsets[e + 1]) and c < D.  The
//     (rows, 2 D) product and every f32 intermediate stay in registers.
//   moe_down: out[dest[r]] = bf16(act[r] . w2[e][n]) for n < H; dest null
//     stores row r at row r.  dest is a permutation: a plain scatter, each
//     row written once, no atomics.
//
// offsets (E + 1 int32, exclusive prefix sums of the groups' row counts)
// stay on the card: the grid is fixed from what the host knows (P, E and
// the tile sizes), and each CTA maps its tiles to (group, row block) by
// searching the offsets.  offsets null: one group of all P rows (the dense
// SwiGLUs).
//
// Bound: 2 P K N operations a launch (N = 2 D, or H), 989 TFLOP/s in bf16;
// the operands read once (P K + E N K values) are a few percent of that
// time at the encoder's shapes, so the tensor cores bound it.
//
// Design (the hopper-kernels guide's shape): persistent CTAs, one an SM,
// walk the work units (row tile, column tile) in raster groups (unit_of),
// so that the CTAs running at one time share row tiles and a slice of the
// weights in L2.  A tile is 128 rows x 256 B rows (moe_gate_up: the 128
// gate rows and the matching 128 up rows of w13[e], so one tile yields 128
// act columns; moe_down: 256 output columns).  One producer lane issues
// TMA loads (rows: a 2-D map over (K, P); weights: a 3-D map over (K, N,
// E)), both in the 128-byte swizzle, into a three-stage mbarrier ring; two
// consumer warpgroups each run wgmma m64n256k16 (A and B from shared
// memory, f32 accumulators in registers) on 64 rows of the tile with one
// wgmma group in flight, then write the tile as bf16 pairs into an
// epilogue buffer in shared memory and go on to the next unit.  Three
// warps of the producer warpgroup take the buffer from there: silu(g) u
// (moe_gate_up) and 16-byte stores of whole rows, at each row's place
// (moe_down), while the consumers' next products run.  The buffer (66 KB)
// takes the room of a fourth stage: measured on the card, the stores
// overlapped with the products were worth more than the deeper ring.
// Rows past a group's end are loaded (the next group's rows, or zeros past
// P) and skipped at the store; an empty group has no tiles.
//
// The arithmetic is the plain version's (ops/moe_grouped.py): products of
// bf16 values summed in f32 (in the tensor cores' order), g and u rounded
// to bf16, silu(g) = g / (1 + exp(-g)) and its product with u in f32,
// rounded once; the down product rounded once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                   // rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;                   // B rows a tile (wgmma's N)
constexpr int BK = 64;                    // depth a stage: one 128-byte swizzle atom of bf16
constexpr int STAGES = 3;                 // ring slots
constexpr int A_BYTES = BM * BK * 2;      // 16 KB
constexpr int B_BYTES = BN * BK * 2;      // 32 KB: two boxes of 128 rows
constexpr int STAGE = A_BYTES + B_BYTES;  // 1024-aligned, as the swizzle needs
constexpr int MAX_E = 256;                // groups a launch
// row tiles a raster group (unit_of): a grouped launch walks row tiles
// first (a group's weights stay in L2 while its rows stream); one group of
// many rows walks 8 row tiles at a time across the columns, so that the
// CTAs running together share 8 row tiles and a slice of the weights
constexpr int RASTER_GROUPED = 1, RASTER_ONE = 8;
constexpr int NCONS = 256;                // consumer threads: a warpgroup per 64 rows
constexpr int NWC = NCONS / 32;           // consumer warps
// and a producer warpgroup: one loading lane and three epilogue warps; at
// 384 threads ptxas holds every thread to 168 registers, which the
// consumers' 128 accumulators fit (setmaxnreg would not lift the limit the
// code is compiled to)
constexpr int NT = NCONS + 128;
// a unit's 128 x 256 results wait in shared memory as bf16 (rows padded by
// 16 bytes: the consumers' 4-byte stores are free of bank conflicts) for
// the producer warpgroup's three epilogue warps
constexpr int EPI_ROW = BN * 2 + 16;
constexpr int EPI_BYTES = BM * EPI_ROW;
constexpr int NEPI = 96;                  // epilogue threads: warps NWC + 1 .. NWC + 3
constexpr int SMEM =
    1024 + STAGES * STAGE + EPI_BYTES + 2 * (MAX_E + 1) * 4 + (2 * STAGES + 2) * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

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

// the box of 128 rows from row r, depth k0 .. k0 + 63, of the 2-D rows map
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int k0, int r,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r), "r"(smem_addr(bar))
        : "memory");
}
// the box of 128 rows from row n of group e, depth k0 .. k0 + 63, of the
// 3-D weights map
__device__ __forceinline__ void tma_weights(void* dst, const CUtensorMap* map, int k0, int n,
                                            int e, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n), "r"(e), "r"(smem_addr(bar))
        : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
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
__device__ __forceinline__ void keep(float (&r)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 256, f32) = (accumulate ? D : 0) + A (64 x 16) x B (16 x 256),
// both K-major in shared memory; the accumulators as mma.sync's over 32
// column tiles of 8: d[4 j + 0, 1] row g, columns 8 j + 2 t, + 1; d[4 j + 2,
// 3] row g + 8 (g = lane / 4, t = lane % 4, rows of the warp's 16)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// unit u -> (row tile t, column tile j): groups of gm row tiles, the
// column tiles of a group in turn, its row tiles within each
__device__ __forceinline__ void unit_of(int u, int tiles, int ntn, int gm, int& t, int& j) {
    const int grp = u / (gm * ntn), in = u % (gm * ntn);
    const int rows = min(gm, tiles - grp * gm);
    t = grp * gm + in % rows;
    j = in / rows;
}

// row tile t -> its group e and rows [r0, rend): e is the group whose tiles
// [tst[e], tst[e + 1]) hold t, found by bisection (t < tst[E])
__device__ __forceinline__ void locate(const int* tst, const int* off, int E, int t, int& e,
                                       int& r0, int& rend) {
    int a = 1, b = E;  // the first i with tst[i] > t
    while (a < b) {
        const int m = (a + b) >> 1;
        if (tst[m] > t) b = m;
        else a = m + 1;
    }
    e = a - 1;
    r0 = off[e] + (t - tst[e]) * BM;
    rend = off[e + 1];
}

// one stage's products: 4 x m64n256k16 over its depth of 64, committed
// as one group (the first of a unit's stages starts the sums from 0)
__device__ __forceinline__ void issue(float (&acc)[128], const unsigned char* a,
                                      const unsigned char* b, int kt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_256(acc, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk), kt | kk);
    wgmma_commit();
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// silu(g) * u of a pair of bf16 gate values and the matching up values, in
// f32, rounded once to a bf16 pair
__device__ __forceinline__ uint32_t swiglu2(uint32_t g, uint32_t u) {
    const float g0 = bf_lo(g), g1 = bf_hi(g);
    return pack_bf16(g0 / (1.0f + expf(-g0)) * bf_lo(u), g1 / (1.0f + expf(-g1)) * bf_hi(u));
}

// One persistent CTA: the units u = blockIdx.x, + gridDim.x, ... of the
// (row tile, column tile) grid (unit_of).  SWIGLU: column tile j is act
// columns 128 j .. 128 j + 127, from w13 rows 128 j .. and N / 2 + 128 j ..
// (N = 2 D), stored at out (P, D); else output columns 256 j .. 256 j + 255
// of out (rows, N), row r at dest[r] (or r).
template <bool SWIGLU>
__global__ void __launch_bounds__(NT, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                   const long long* __restrict__ dest, uint16_t* __restrict__ out, int P, int E,
                   int K, int N, int gm) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    unsigned char* epi = ring + STAGES * STAGE;
    int* off = reinterpret_cast<int*>(epi + EPI_BYTES);
    int* tst = off + MAX_E + 1;
    uint64_t* full = reinterpret_cast<uint64_t*>(tst + MAX_E + 1);
    uint64_t* empty = full + STAGES;
    uint64_t* epi_full = empty + STAGES;  // a unit's results are in epi
    uint64_t* epi_free = epi_full + 1;    // ... and have been stored

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ntn = N / BN;                     // column tiles
    const int ldo = SWIGLU ? N / 2 : N;         // out's row length
    const int kt_n = K / BK;

    for (int i = tid; i <= E; i += NT) off[i] = offsets ? offsets[i] : (i == 0 ? 0 : P);
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, NWC);
        }
        mbar_init(epi_full, NWC);
        mbar_init(epi_free, NEPI / 32);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {  // tst: exclusive prefix sums of the groups' row tiles
        int carry = 0;
        for (int base = 0; base < E; base += 32) {
            const int e = base + lane;
            int c = e < E ? (off[e + 1] - off[e] + BM - 1) / BM : 0;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, c, o);
                if (lane >= o) c += y;
            }
            if (e < E) tst[e + 1] = carry + c;
            carry += __shfl_sync(0xffffffffu, c, 31);
        }
        if (lane == 0) tst[0] = 0;
    }
    __syncthreads();
    const int units = tst[E] * ntn;

    if (warp >= NWC) {  // the producer warpgroup: a loading lane, three epilogue warps
        if (warp == NWC && lane == 0) {
            int it = 0;
            for (int u = blockIdx.x; u < units; u += gridDim.x) {
                int t, j, e, r0, rend;
                unit_of(u, tst[E], ntn, gm, t, j);
                locate(tst, off, E, t, e, r0, rend);
                const int b0 = SWIGLU ? 128 * j : BN * j;
                const int b1 = SWIGLU ? N / 2 + 128 * j : BN * j + 128;
                for (int kt = 0; kt < kt_n; ++kt, ++it) {
                    const int slot = it % STAGES, use = it / STAGES;
                    if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
                    unsigned char* s = ring + slot * STAGE;
                    mbar_expect(full + slot, STAGE);
                    tma_rows(s, &amap, kt * BK, r0, full + slot);
                    tma_weights(s + A_BYTES, &wmap, kt * BK, b0, e, full + slot);
                    tma_weights(s + A_BYTES + B_BYTES / 2, &wmap, kt * BK, b1, e, full + slot);
                }
            }
        } else if (warp > NWC) {
            // each unit's rows from epi, 16 bytes (8 columns) a thread at a
            // time: SWIGLU silu(g) u of gate columns c and up columns 128 + c
            // into act columns 128 j + c; else output columns 256 j + c, at
            // row dest[r] (or r)
            constexpr int CH = SWIGLU ? 16 : 32;  // 16-byte pieces of an output row
            const int et = tid - (NWC + 1) * 32;
            int n = 0;
            for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
                int t, j, e, r0, rend;
                unit_of(u, tst[E], ntn, gm, t, j);
                locate(tst, off, E, t, e, r0, rend);
                mbar_wait(epi_full, n & 1);
                for (int q = et; q < BM * CH; q += NEPI) {
                    const int r = q / CH, c8 = 8 * (q % CH);
                    if (r0 + r >= rend) continue;
                    const unsigned char* src = epi + r * EPI_ROW + 2 * c8;
                    uint4 v = *reinterpret_cast<const uint4*>(src);
                    if (SWIGLU) {
                        const uint4 up = *reinterpret_cast<const uint4*>(src + 256);
                        v = make_uint4(swiglu2(v.x, up.x), swiglu2(v.y, up.y), swiglu2(v.z, up.z),
                                       swiglu2(v.w, up.w));
                    }
                    const long long row = dest ? dest[r0 + r] : r0 + r;
                    *reinterpret_cast<uint4*>(out + (size_t)row * ldo + (SWIGLU ? 128 : BN) * j +
                                              c8) = v;
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(epi_free);
            }
        }
        return;
    }

    const int row = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);  // the lane's first row
    unsigned char* mine = epi + row * EPI_ROW + 4 * (lane & 3);        // ... and its pairs
    const unsigned char* a_wg = ring + (warp >> 2) * (64 * BK * 2);
    float acc[128];
    int it = 0, n = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
            const int slot = it % STAGES;
            mbar_wait(full + slot, (it / STAGES) & 1);
            issue(acc, a_wg + slot * STAGE, ring + slot * STAGE + A_BYTES, kt);
            wgmma_wait<1>();
            if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
        }
        wgmma_wait<0>();
        keep(acc);
        if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
        // the tile's rows as bf16 pairs into epi, once the last unit's are out
        if (n > 0) mbar_wait(epi_free, (n - 1) & 1);
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            *reinterpret_cast<uint32_t*>(mine + 16 * c) = pack_bf16(acc[4 * c], acc[4 * c + 1]);
            *reinterpret_cast<uint32_t*>(mine + 8 * EPI_ROW + 16 * c) =
                pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(epi_full);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the TMA descriptor of a bf16 tensor (groups, rows, K) as (K, rows,
// groups) (rank 2 without the groups): boxes of 64 x 128 rows (of one
// group) in the 128-byte swizzle, zeros past the last row;
// cuTensorMapEncodeTiled is looked up at run time, so the library links
// nothing beyond the CUDA runtime
int box_map(CUtensorMap* map, const void* x, int rank, int K, int rows, int groups) {
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
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)groups};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)rows * K * 2};
    const cuuint32_t box[3] = {BK, 128, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(x),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a (P, K) x (E, N, K) grouped launch: min(SMs, units' upper bound) CTAs
template <bool SWIGLU>
int grouped(const void* x, const void* w, const void* offsets, const void* dest, int P, int E,
            int K, int N, int gm, void* out, cudaStream_t stream) {
    if (P <= 0) return 0;
    if (E < 1 || E > MAX_E || K % BK || N % BN || (offsets == nullptr && E != 1))
        return (int)cudaErrorInvalidValue;
    CUtensorMap amap, wmap;
    int err = box_map(&amap, x, 2, K, P, 1);
    if (err != 0) return err;
    err = box_map(&wmap, w, 3, K, N, E);
    if (err != 0) return err;
    auto kern = moe_grouped_kernel<SWIGLU>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // row tiles: at most one partial tile a group beyond ceil(P / BM)
    const long long tiles = (P + BM - 1) / BM + (offsets ? E : 0);
    const long long units = tiles * (N / BN);
    const int grid = (int)(units < sms ? units : sms);
    kern<<<grid, NT, SMEM, stream>>>(amap, wmap, (const int*)offsets, (const long long*)dest,
                                     (uint16_t*)out, P, E, K, N, gm);
    return (int)cudaGetLastError();
}

}  // namespace

// act (P, D) = bf16(silu(x w13[e][:D]^T) * (x w13[e][D:]^T)) over each
// group's rows: x (P, K), w13 (E, 2 D, K), act (P, D) bf16, contiguous and
// 16-byte aligned; offsets (E + 1) int32 on the card, or null for one
// group (E = 1); K % 64 == 0, D % 128 == 0, E <= 256 (checked by the
// Python wrapper, ops/moe_grouped.py).  Returns the launch's cudaError_t.
extern "C" int moe_gate_up(const void* x, const void* w13, const void* offsets, int P, int E,
                           int K, int D, void* act, void* stream) {
    return grouped<true>(x, w13, offsets, nullptr, P, E, K, 2 * D,
                         offsets ? RASTER_GROUPED : RASTER_ONE, act, (cudaStream_t)stream);
}

// out[dest[r]] = bf16(act[r] w2[e]^T) over each group's rows: act (P, D),
// w2 (E, H, D), out (rows, H) bf16; dest (P) int64, a permutation into
// out's rows, or null (row r at row r); D % 64 == 0, H % 256 == 0.
extern "C" int moe_down(const void* act, const void* w2, const void* offsets, const void* dest,
                        int P, int E, int D, int H, void* out, void* stream) {
    return grouped<false>(act, w2, offsets, dest, P, E, D, H, offsets ? RASTER_GROUPED : RASTER_ONE,
                          out, (cudaStream_t)stream);
}
