// Shared pieces of the port's CUDA kernels: the C export macro, the norm
// codes the Python wrappers pass, and the per-norm reduction monoid.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Norm codes (kernels/codegen/lowering.py: NORM_CODES). Runtime arguments,
// uniform across a launch, so every branch on them is warp-uniform.
enum : int { NORM_L1 = 0, NORM_L2 = 1, NORM_LINF = 2 };

// max / min that return NaN when either operand is NaN, as torch.maximum,
// torch.amax, torch.clamp and jnp.max do (fmaxf / fminf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// The staged reduction of one norm on non-negative inputs (lowering.py's
// MONOIDS in the JAX package): 0 is the identity of all three, which is also
// why masked or absent rows may contribute 0. A NaN propagates through all
// three, as through the plain version's amax and sum.
//   fold     — add one raw element to an accumulator (ℓ2 accumulates squares)
//   combine  — merge two accumulators
//   finalize — accumulator -> norm (ℓ2 takes the square root after the pass)
__device__ __forceinline__ float fold(int q, float acc, float x) {
  if (q == NORM_LINF) return max_nan(acc, x);
  if (q == NORM_L2) return acc + x * x;
  return acc + x;
}

__device__ __forceinline__ float combine(int q, float a, float b) {
  return q == NORM_LINF ? max_nan(a, b) : a + b;
}

__device__ __forceinline__ float finalize(int q, float acc) {
  return q == NORM_L2 ? sqrtf(acc) : acc;
}

// sign(x) * max(|x| - theta, 0): the soft threshold of an ℓ1 projection,
// NaN kept as torch.sign(x) * torch.clamp(|x| - θ, min=0) keeps it (a NaN x
// or θ gives NaN).
__device__ __forceinline__ float soft_threshold(float x, float theta) {
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * max_nan(fabsf(x) - theta, 0.f);
}

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
