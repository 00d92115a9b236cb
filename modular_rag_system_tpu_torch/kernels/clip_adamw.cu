// clip_adamw: the trainer's update, global-norm clip and AdamW, over flat
// f32 buffers on Hopper.
//
// Replaces no TPU kernel: the JAX trainer leaves optax's clip_by_global_norm
// and adamw to XLA, which fuses them.  The port's eager update launched
// about 20 elementwise kernels a tensor (some 1,400 for the shipped
// encoder's 68 tensors), each a few microseconds of host work, so the host
// took ~20 ms a step for ~0.15 ms of device work.  Here the trainer keeps
// its f32 masters p, first moments mu and second moments nu each in one
// contiguous buffer (the tensors that the model axis splits first, the
// replicated ones after, at element `split`) and concatenates the gradient
// g in the same order; two launches do the whole update:
//
//   clip_adamw_norm   per-CTA f32 sums of g^2, one for [0, split) and one
//                     for [split, n), into partials (2, grid)
//   clip_adamw_apply  every CTA sums the partials in a fixed order to the
//                     norm (on the model path the split sum comes summed
//                     over the model group instead), then one pass over
//                     the elements:
//
//     g  = norm < clip ? g : g / norm * clip        (optax's trigger)
//     mu = b1 mu + (1 - b1) g
//     nu = b2 nu + (1 - b2) g^2
//     u  = (mu * inv_bc1) / (sqrt(nu * inv_bc2) + eps)
//     p  = p + (u + wd p) * step                    (step = -lr)
//
// Each operation is rounded as the plain PyTorch version
// (ops/clip_adamw.py clip_adamw_reference) rounds it on the card: every
// product, sum, quotient and root on its own (the _rn intrinsics, so the
// compiler contracts nothing into an FMA), and the bias corrections as
// products by their f32 reciprocals, as PyTorch divides a tensor by a
// scalar on the card.  b1, b2 and eps are optax's defaults, fixed here and
// in the plain version; the step's scalars (the bias corrections' f32
// reciprocals, wd, -lr, clip) arrive as arguments, computed on the host
// from its step count: nothing is read back, nothing synchronizes.
//
// No float atomics: the grid is fixed by the caller (a multiple of the 132
// SMs), each thread walks its elements in a fixed order and each block sums
// in a fixed tree, so the same inputs give the same bits on every run, and
// replicated tensors stay bit-identical across model ranks.
//
// Bound: bytes.  p, g, mu and nu read once and p, mu and nu written once
// (28 B an element) plus the norm's read of g (4 B): 430 MB for the
// shipped encoder's 13,439,232 parameters, 0.128 ms at 3.35 TB/s.  The
// operations (two IEEE divisions and a root an element) stay under the
// bytes' time.  Loads and stores are 16-byte vectors with a scalar tail;
// the wrapper checks that every buffer is 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// optax's adamw defaults (ops/clip_adamw.py B1, B2, EPS), 1 - b rounded
// to f32 as the plain version rounds it
constexpr float B1 = 0.9f, OMB1 = 0.1f, B2 = 0.999f, OMB2 = 0.001f, EPS = 1e-8f;

struct Hyper {
    float inv_bc1, inv_bc2, wd, step, clip;
};

// (a, b) summed over the block in a fixed tree; every thread gets the sums
__device__ __forceinline__ float2 block_sum2(float a, float b) {
    __shared__ float2 red[WARPS + 1];
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    if (warp == 0) {
        float2 v = lane < WARPS ? red[lane] : make_float2(0.f, 0.f);
        for (int o = 16; o > 0; o >>= 1) {
            v.x += __shfl_down_sync(0xffffffffu, v.x, o);
            v.y += __shfl_down_sync(0xffffffffu, v.y, o);
        }
        if (lane == 0) red[WARPS] = v;
    }
    __syncthreads();
    return red[WARPS];
}

__device__ __forceinline__ void square_into(float x, int e, int split, float& s, float& r) {
    if (e < split)
        s = fmaf(x, x, s);
    else
        r = fmaf(x, x, r);
}

__global__ void __launch_bounds__(THREADS)
clip_adamw_norm_kernel(const float* __restrict__ g, int n, int split,
                       float* __restrict__ partials) {
    float s = 0.f, r = 0.f;
    const int n4 = n >> 2;
    const int stride = gridDim.x * THREADS;
    const int first = blockIdx.x * THREADS + threadIdx.x;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = first; i < n4; i += stride) {
        const float4 x = __ldg(g4 + i);
        const int e = i << 2;
        if (e + 3 < split) {
            s = fmaf(x.x, x.x, s);
            s = fmaf(x.y, x.y, s);
            s = fmaf(x.z, x.z, s);
            s = fmaf(x.w, x.w, s);
        } else if (e >= split) {
            r = fmaf(x.x, x.x, r);
            r = fmaf(x.y, x.y, r);
            r = fmaf(x.z, x.z, r);
            r = fmaf(x.w, x.w, r);
        } else {  // the one vector that holds the boundary
            square_into(x.x, e, split, s, r);
            square_into(x.y, e + 1, split, s, r);
            square_into(x.z, e + 2, split, s, r);
            square_into(x.w, e + 3, split, s, r);
        }
    }
    const int t = (n4 << 2) + first;  // the tail of n % 4 elements
    if (t < n) square_into(g[t], t, split, s, r);
    const float2 sum = block_sum2(s, r);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = sum.x;
        partials[gridDim.x + blockIdx.x] = sum.y;
    }
}

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, float norm,
                                      bool keep, const Hyper& h) {
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), h.clip);
    m = __fadd_rn(__fmul_rn(m, B1), __fmul_rn(OMB1, g));
    v = __fadd_rn(__fmul_rn(v, B2), __fmul_rn(OMB2, __fmul_rn(g, g)));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), EPS);
    const float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1), den);
    p = __fadd_rn(p, __fmul_rn(__fadd_rn(u, __fmul_rn(h.wd, p)), h.step));
}

__global__ void __launch_bounds__(THREADS)
clip_adamw_apply_kernel(float* __restrict__ p, const float* __restrict__ g,
                        float* __restrict__ mu, float* __restrict__ nu, int n,
                        const float* __restrict__ partials, int parts,
                        const float* __restrict__ split_sum, float* __restrict__ norm_out,
                        Hyper h) {
    float s = 0.f, r = 0.f;
    for (int i = threadIdx.x; i < parts; i += THREADS) {
        s += partials[i];
        r += partials[parts + i];
    }
    const float2 sum = block_sum2(s, r);
    const float split_total = split_sum != nullptr ? *split_sum : sum.x;
    const float norm = __fsqrt_rn(__fadd_rn(split_total, sum.y));
    const bool keep = norm < h.clip;
    if (blockIdx.x == 0 && threadIdx.x == 0 && norm_out != nullptr) *norm_out = norm;

    const int n4 = n >> 2;
    const int stride = gridDim.x * THREADS;
    const int first = blockIdx.x * THREADS + threadIdx.x;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* v4 = reinterpret_cast<float4*>(nu);
    for (int i = first; i < n4; i += stride) {
        float4 pv = p4[i], mv = m4[i], vv = v4[i];
        const float4 gv = __ldg(g4 + i);
        adamw(pv.x, gv.x, mv.x, vv.x, norm, keep, h);
        adamw(pv.y, gv.y, mv.y, vv.y, norm, keep, h);
        adamw(pv.z, gv.z, mv.z, vv.z, norm, keep, h);
        adamw(pv.w, gv.w, mv.w, vv.w, norm, keep, h);
        p4[i] = pv;
        m4[i] = mv;
        v4[i] = vv;
    }
    const int t = (n4 << 2) + first;
    if (t < n) adamw(p[t], g[t], mu[t], nu[t], norm, keep, h);
}

}  // namespace

// g (n,) f32, 16-byte aligned; partials (2, grid) f32: row 0 the CTAs'
// sums of g^2 over [0, split), row 1 over [split, n).
extern "C" int clip_adamw_norm(const void* g, int n, int split, int grid, void* partials,
                               void* stream) {
    clip_adamw_norm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)g, n, split, (float*)partials);
    return (int)cudaGetLastError();
}

// p, mu, nu updated in place from g and clip_adamw_norm's partials (grid
// CTAs' worth); split_sum (one f32, or null): the split segment's sum of
// squares over the model group, which then replaces the partials' row 0;
// norm_out (one f32, or null) receives the global norm.
extern "C" int clip_adamw_apply(void* p, const void* g, void* mu, void* nu, int n,
                                const void* partials, int grid, const void* split_sum,
                                void* norm_out, float inv_bc1, float inv_bc2, float wd,
                                float step, float clip, void* stream) {
    const Hyper h{inv_bc1, inv_bc2, wd, step, clip};
    clip_adamw_apply_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (float*)p, (const float*)g, (float*)mu, (float*)nu, n, (const float*)partials, grid,
        (const float*)split_sum, (float*)norm_out, h);
    return (int)cudaGetLastError();
}
