// fine_scores: the ivf fine stage's score dump on Hopper.
//
// Replaces modular_rag_system_tpu/ops/ivf2.py:_fine_scores_kernel (via
// fine_scores_call).  For query i and its candidate block list
// blk/vcnt (Q, L) it writes
//
//     out[i, j * SLAB + r] = bf16(q_i) . E_c3[blk[i, j], r]  (x scales3[blk, r] for int8, int4)
//
// for r < vcnt[i, j], and -inf for r >= vcnt[i, j], as (Q, L * SLAB) f32.
// The fine copy E_c3 is (nblocks, SLAB, d) bf16 or int8, or (nblocks,
// SLAB / 2, d) bytes of two int4 rows each (fine_common.cuh), with per-row
// f32 scales for int8 and int4; products are summed in f32 and a quantized
// row is scaled after its dot, as in the TPU kernel.
//
// Bound: memory.  The card must read the probed slabs (the union over the
// batch's queries, each slab once) and write Q * L * SLAB * 4 bytes of
// scores; the operations (2 * Q * L * SLAB * d) are far below the tensor
// cores' rate.  A batch's queries probe the same slabs many times over
// (at the smoke's int8 Q = 256, about 20,000 pairs name about 8,400
// slabs), so reading a slab once per (query, slot) pair reads over twice
// the bound's bytes.  What limits the kernel on the card is the CUDA
// cores' issue rate, though: every score is one warp's conversions, FMAs
// and butterfly in fine_common.cuh's order (the tensor cores cannot give
// those bits), so reading each slab once saves memory traffic but no
// arithmetic.
//
// Design: the (query, slot) pairs are sorted on the device by block
// (``perm``, from the wrapper; dead pairs last), and CTA c takes the
// sorted pairs [c P, c P + P) with their queries in shared memory as f32
// (P d 4 bytes).  It walks the runs of equal blocks in its chunk: for each
// group of ROWS stored rows below the run's largest vcnt a warp loads the
// rows into registers once (fine_common.cuh load_rows) and scores them
// against every pair of the run (dot_rows), writing a pair's rows below
// its own vcnt.  So a slab is read once per chunk that lists it, at most
// (unique slabs + chunks) reads in all.  Each score is the same lanes'
// sums in the same order as in fine_topk.cu and fine_binmax.cu, so the
// three agree bit for bit (the JAX package's invariant: the selecting
// kernel's values are this kernel's own arithmetic).  With P = 1 (the
// wrapper's plan at Q = 1 and for int4) there is no sort and ``perm`` is
// null: one CTA per pair.  A dead pair writes -inf and reads nothing, and
// rows past vcnt are not read.

#include "fine_common.cuh"

namespace {

constexpr int NT = fine::SLAB;  // one thread per slab row for the -inf fill
constexpr int NWARPS = NT / 32;
constexpr int MAX_P = 16;  // pairs a CTA at most (ops/ivf2.py fine_scores_plan takes 8)

// stored rows a warp holds in registers: 8 int8 rows (128 registers a
// thread, no spill; 4 were slower at the smoke's shapes), 4 bf16 rows (8
// would be 128 registers of row data alone) or int4 rows (8 spilled)
template <int MODE>
__host__ __device__ constexpr int rows_held() { return MODE == fine::INT8 ? 8 : 4; }

// marks the rows in ``v`` as rewritten (no instruction), so the loop over a
// run's pairs converts them again for each pair: left to itself, nvcc keeps
// every converted value live across that loop, up to 255 registers a
// thread (one CTA an SM), which was slower than converting again
template <int MODE, int ROWS>
__device__ __forceinline__ void keep_rows(uint4 (&v)[ROWS][fine::lane_vectors<MODE>()]) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int i = 0; i < fine::lane_vectors<MODE>(); ++i)
            asm volatile("" : "+r"(v[j][i].x), "+r"(v[j][i].y), "+r"(v[j][i].z), "+r"(v[j][i].w));
}

// ONE: P = 1, so every loop over a chunk's pairs has one trip, known to
// the compiler (the rows then go from load to dot as in a kernel of one
// pair a CTA)
template <int MODE, bool ONE>
__global__ void __launch_bounds__(NT)
fine_scores_kernel(const uint4* __restrict__ E_c3, const float* __restrict__ scales3,
                   const uint16_t* __restrict__ q_bf16, const int32_t* __restrict__ blk,
                   const int32_t* __restrict__ vcnt, const int64_t* __restrict__ perm,
                   long long npairs, int L, int d, int P, float* __restrict__ out) {
    extern __shared__ __align__(16) float qs[];  // P x d
    __shared__ long long pos[MAX_P];              // each pair's position in (Q, L)
    __shared__ int pblk[MAX_P], pvc[MAX_P];
    const long long p0 = (long long)blockIdx.x * P;
    const int n = ONE ? 1 : (int)min((long long)P, npairs - p0);
    if (threadIdx.x < n) {
        const long long x = perm ? perm[p0 + threadIdx.x] : p0 + threadIdx.x;
        pos[threadIdx.x] = x;
        pblk[threadIdx.x] = blk[x];
        pvc[threadIdx.x] = min(vcnt[x], fine::SLAB);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
        const int vc = pvc[t];
        if (threadIdx.x >= vc) out[pos[t] * fine::SLAB + threadIdx.x] = -INFINITY;
        if (vc > 0) fine::load_query(q_bf16 + (pos[t] / L) * d, d, qs + 4 * (t * (d / 4)));
    }
    __syncthreads();

    constexpr int ROWS = rows_held<MODE>(), NOUT = fine::outputs<MODE, ROWS>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nvec = fine::row_vectors<MODE>(d);
    for (int s = 0; s < n;) {
        if (pvc[s] <= 0) {  // a dead pair: nothing to read
            ++s;
            continue;
        }
        const int b = pblk[s];
        int e = s + 1, vmax = pvc[s];
        for (; e < n && pvc[e] > 0 && pblk[e] == b; ++e) vmax = max(vmax, pvc[e]);
        const uint4* slab = E_c3 + (size_t)b * fine::stored_slab<MODE>() * nvec;
        const float* sc = scales3 + (size_t)b * fine::SLAB;
        const int rmax = fine::stored_rows<MODE>(vmax);
        for (int r0 = warp * ROWS; r0 < rmax; r0 += NWARPS * ROWS) {
            uint4 v[ROWS][fine::lane_vectors<MODE>()];
            fine::load_rows<MODE, ROWS>(slab, nvec, r0, rmax, lane, v);
            for (int t = s; t < e; ++t) {
                const int vc = pvc[t], rlim = fine::stored_rows<MODE>(vc);
                if (r0 >= rlim) continue;
                float acc[NOUT];
                // pair t's query, at an offset the compiler sees is a
                // multiple of 16 bytes, so its reads stay 16-byte ones
                fine::dot_rows<MODE, ROWS>(v, nvec, qs + 4 * (t * (d / 4)), lane, acc);
                const int r = fine::logical_row<ROWS>(r0, lane);
                if (lane < NOUT && r0 + lane % ROWS < rlim && r < vc) {
                    const float a = fine::pick<NOUT>(acc, lane);
                    out[pos[t] * fine::SLAB + r] = MODE == fine::BF16 ? a : a * sc[r];
                }
                if (!ONE) keep_rows<MODE, ROWS>(v);
            }
        }
        s = e;
    }
}

template <int MODE, bool ONE>
int launch(const dim3 grid, size_t smem, cudaStream_t s, const void* E_c3,
           const void* scales3, const void* q_bf16, const void* blk, const void* vcnt,
           const void* perm, long long npairs, int L, int d, int P, void* out) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        fine_scores_kernel<MODE, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_P * 1024 * (int)sizeof(float));
    if (attr != cudaSuccess) return (int)attr;
    fine_scores_kernel<MODE, ONE><<<grid, NT, smem, s>>>(
        (const uint4*)E_c3, (const float*)scales3, (const uint16_t*)q_bf16,
        (const int32_t*)blk, (const int32_t*)vcnt, (const int64_t*)perm, npairs, L, d, P,
        (float*)out);
    return (int)cudaGetLastError();
}

template <int MODE>
int launch(const dim3 grid, size_t smem, cudaStream_t s, const void* E_c3,
           const void* scales3, const void* q_bf16, const void* blk, const void* vcnt,
           const void* perm, long long npairs, int L, int d, int P, void* out) {
    return P == 1 ? launch<MODE, true>(grid, smem, s, E_c3, scales3, q_bf16, blk, vcnt, perm,
                                       npairs, L, d, P, out)
                  : launch<MODE, false>(grid, smem, s, E_c3, scales3, q_bf16, blk, vcnt, perm,
                                        npairs, L, d, P, out);
}

}  // namespace

// E_c3 (nblocks, 256, d) bf16 (mode 0) or int8 (mode 1), or (nblocks, 128, d)
// packed int4 bytes (mode 2), with scales3 (nblocks, 256) f32 (unused for
// bf16), q_bf16 (Q, d) bf16 bits, blk/vcnt (Q, L) int32, perm (Q L,) int64
// the pairs' flat positions in (Q, L) sorted by block (null: in order,
// only with P = 1), P pairs a CTA (1 <= P <= 16), out (Q, L * 256) f32.
// d % 16 == 0, d <= 1024, Q <= 65535 (checked by the Python wrapper).
// Returns the launch's cudaError_t.
extern "C" int fine_scores(const void* E_c3, int mode, const void* scales3,
                           const void* q_bf16, const void* blk, const void* vcnt,
                           const void* perm, int Q, int L, int d, int P, void* out,
                           void* stream) {
    if (P < 1 || P > MAX_P || (P > 1 && !perm)) return (int)cudaErrorInvalidValue;
    const long long npairs = (long long)Q * L;
    const dim3 grid((unsigned)((npairs + P - 1) / P));
    const size_t smem = (size_t)P * d * sizeof(float);
    const cudaStream_t s = (cudaStream_t)stream;
    if (mode == fine::INT4)
        return launch<fine::INT4>(grid, smem, s, E_c3, scales3, q_bf16, blk, vcnt, perm,
                                  npairs, L, d, P, out);
    if (mode == fine::INT8)
        return launch<fine::INT8>(grid, smem, s, E_c3, scales3, q_bf16, blk, vcnt, perm,
                                  npairs, L, d, P, out);
    return launch<fine::BF16>(grid, smem, s, E_c3, scales3, q_bf16, blk, vcnt, perm, npairs,
                              L, d, P, out);
}
