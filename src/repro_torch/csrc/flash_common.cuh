// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the TPU kernels' pair mask and the warp mask of the row shuffles.
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

}  // namespace flash
