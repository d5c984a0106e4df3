// golden.cuh — pieces shared by the hand-written golden kernels of the
// paper's Algorithms 2 and 5 (bilevel_l1inf.cu, trilevel_l1infinf.cu):
// storage types, 16-byte vector access, the NaN-propagating clip (on
// common.cuh's max_nan / min_nan), and the fold of loaded packs into
// column maxima.
//
// These kernels are an independent second implementation of what the
// generated pipeline (codegen_reduce.cu, codegen_apply.cu) computes for the
// bi-level and tri-level ℓ1,∞ designs, so they share none of its bodies.
//
// Storage: float32 (`float`) or bf16 kept as its raw bits (`unsigned short`).
// Every value the golden kernels write is one of their inputs' values, its
// negation, or NaN (maxima, clips, minima: no arithmetic rounds), so the
// bf16 narrowing below is a truncation of the widened bits and is exact.
#pragma once

#include "common.cuh"

namespace golden {

enum : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // kernels/bilevel_l1inf.py

constexpr int BM = 32;  // column threads per CTA: one warp across a row
constexpr int BR = 8;   // thread rows per CTA

using bf16_bits = unsigned short;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <typename S>
__device__ __forceinline__ S narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_bits narrow<bf16_bits>(float x) {
  return static_cast<bf16_bits>(__float_as_uint(x) >> 16);
}

// clip(y, -u, u) = min(max(y, -u), u), jnp.clip's order of operations
__device__ __forceinline__ float clip_nan(float y, float u) {
  return min_nan(max_nan(y, -u), u);
}

// VEC consecutive elements of one row; VEC * sizeof(S) == 16 makes every
// access one 16-byte load or store (the wrapper checks the alignment).
template <typename S, int VEC>
struct alignas(VEC * sizeof(S)) Pack {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> load(const S* p) {
  return *reinterpret_cast<const Pack<S, VEC>*>(p);
}

template <typename S, int VEC>
__device__ __forceinline__ void store(S* p, const Pack<S, VEC>& x) {
  *reinterpret_cast<Pack<S, VEC>*>(p) = x;
}

// acc[k] = max(acc[k], |x[u].v[k]|) over the loaded packs, NaN kept
template <typename S, int VEC, int LOADS>
__device__ __forceinline__ void fold_abs_max(float (&acc)[VEC],
                                             const Pack<S, VEC> (&x)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], fabsf(widen(x[u].v[k])));
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace golden
