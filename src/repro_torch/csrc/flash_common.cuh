// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the TPU kernels' pair mask, the warp mask of the row shuffles and the
// head dims the kernels take.
//
// Every kernel takes float32 or bf16 q/k/v (and o/do in the backward) and
// does every product, exp and sum in float32 accumulators, as the TPU
// kernels' .astype(f32) does; outputs are written back in the input type,
// lse and delta stay f32.
#pragma once

#include "common.cuh"

namespace flash {

constexpr unsigned FULL = 0xffffffffu;

// the (query, key) validity of the TPU kernels' _block_mask: key inside the
// keys, query row inside the rows (qpos < sk), causal, sliding window
__device__ __forceinline__ bool valid(int qpos, int kpos, int sk, int causal,
                                      int window) {
  bool ok = kpos < sk && qpos < sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// The instantiated width that runs head dim d: the next of 16, 32, 64 and
// 128 up, or 0 outside the kernels' contract (d a multiple of 8 from 8 to
// 128: TMA takes global strides of whole 16 bytes, d · 2 in bf16). Every
// TMA box is that wide over an array described at its true d, so the
// columns from d on read as 0: they add nothing to a product over the head
// dim, give zero columns of O, dQ, dK and dV, and no store writes them.
inline int padded_width(int d) {
  if (d < 8 || d > 128 || d % 8) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

}  // namespace flash
