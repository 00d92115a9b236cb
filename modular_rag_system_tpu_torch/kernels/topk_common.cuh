// Shared device code of the port's selecting kernels: (score, id) keys,
// the bitonic sort of a shared-memory key array, and the exact conversions
// of int8, packed int4 and bf16 values to f32.
//
// A (score, id) pair packs into one 64-bit key whose ascending order is
// (score desc, id asc), the TPU kernels' selection order, so a selection
// step is a plain sort of unique keys.  -0 folds into +0, as the TPU
// kernels' compare treats them.  EMPTY sorts after every real key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float s, int id) {
    if (s == 0.0f) s = 0.0f;  // -0 ties +0
    uint32_t u = __float_as_uint(s);
    // ascending-orderable bits of s, inverted so larger scores sort first
    uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)(~asc) << 32) | (uint32_t)id;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
    uint32_t asc = ~(uint32_t)(key >> 32);
    uint32_t u = (asc & 0x80000000u) ? (asc & 0x7FFFFFFFu) : ~asc;
    return __uint_as_float(u);
}

// byte b of v as a float, exactly: the byte biased to unsigned (x = b + 128)
// becomes the low mantissa bits of 2^23 + x (one byte permute), and
// subtracting 2^23 + 128 leaves b.  Cheaper than the quarter-rate I2F.
__device__ __forceinline__ float int8_to_float(int32_t v, int b) {
    const uint32_t x = (uint32_t)v ^ 0x80808080u;
    return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + b)) - 8388736.0f;
}

// the four high (or low) nibbles of v's bytes, each a 4-bit two's
// complement value, biased to unsigned (n ^ 8 = value + 8) in the bytes of
// the result; nibble_to_float then converts byte b exactly, as above
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t v) {
    return ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t v) {
    return (v & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ float nibble_to_float(uint32_t biased, int b) {
    return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + b)) - 8388616.0f;
}

// the two bf16 values packed in a 32-bit word, low half first
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// f32 -> the nearest bf16 value (ties to even), kept as f32
__device__ __forceinline__ float round_bf16(float x) {
    uint32_t u = __float_as_uint(x);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xFFFF0000u);
}

// ascending sort of T (a power of two) keys by the NT threads of a block
template <int NT>
__device__ void bitonic_sort(unsigned long long* keys, int T) {
    for (int size = 2; size <= T; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < T / 2; i += NT) {
                const int lo = (i / stride) * 2 * stride + (i % stride);
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const unsigned long long a = keys[lo], b = keys[hi];
                if ((a > b) == up) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

}  // namespace topk
