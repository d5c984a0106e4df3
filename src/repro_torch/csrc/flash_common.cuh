// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// loads and stores of the element types they take, and the tile geometry.
//
// Both kernels take float32 or bf16 q/k/v (and o/do in the backward) and do
// every product, exp and sum in float32, as the TPU kernels' .astype(f32)
// does; outputs are written back in the input type, lse and delta stay f32.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace flash {

constexpr int TILE = 64;             // rows (q) or keys per shared-memory tile
constexpr int THREADS = 256;         // 16 x 16
constexpr int LD = TILE + 4;         // row stride of a transposed tile (float4-aligned)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a torch cast does
}

// four consecutive elements (16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// channel held in accumulator slot jd by lane tx (ND = D / 16 slots): four
// consecutive channels per lane and 64-channel group when D >= 64, so a
// lane's slots are float4 loads from a row in shared memory
template <int D>
__device__ __forceinline__ int dcol(int tx, int jd) {
  constexpr int ND = D / 16;
  if constexpr (ND >= 4) return (jd / 4) * 64 + tx * 4 + (jd % 4);
  else return tx * ND + jd;
}

// the ND channels of lane tx in one row of a shared-memory tile
template <int D>
__device__ __forceinline__ void row_slots(const float* row, int tx, float* out) {
  constexpr int ND = D / 16;
  if constexpr (ND >= 4) {
#pragma unroll
    for (int g = 0; g < ND / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(&row[g * 64 + tx * 4]);
      out[4 * g] = t.x;
      out[4 * g + 1] = t.y;
      out[4 * g + 2] = t.z;
      out[4 * g + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) out[jd] = row[dcol<D>(tx, jd)];
  }
}

// the (query, key) validity of the TPU kernels' _block_mask: key inside the
// keys, query row inside the rows (qpos < sk), causal, sliding window
__device__ __forceinline__ bool valid(int qpos, int kpos, int sk, int causal,
                                      int window) {
  bool ok = kpos < sk && qpos < sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

}  // namespace flash
