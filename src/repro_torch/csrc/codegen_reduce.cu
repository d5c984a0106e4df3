// codegen_reduce.cu — every forward aggregate of a norm design in one pass
// over Y, for a batch of items.
//
// Replaces the generated TPU reduce kernels of
// repro/kernels/codegen/lowering.py: _reduce_call (_make_reduce_kernel) and
// _reduce_call_batched (_make_batched_reduce_kernel).
//
// Layout: item b of Y is the canonical view (g1, g2, n, m) of its schedule,
// with LEAD = 0, 1 or 2 leading "lead" axes (depth <= 4). Levels 1..L-2 fold
// the lead axes with their norms' monoids; level L-1 (`qlast`) reduces the
// row axis n. Outputs: v1 (B, [g2,] n, m) and v2 (B, n, m) — the
// intermediate aggregates the apply pass reuses — and vfin (B, m), the
// finalized last-level aggregate the outer θ-solve projects, or with `raw`
// the last level's raw accumulator (ℓ2: the sum of squares) — what the mesh
// executor combines across ranks before it finalizes
// (kernels/codegen/distributed.py).
//
// Pallas carried the row accumulator across a sequential grid axis. Hopper
// runs CTAs in no order, so the row axis is split instead: a CTA covers 32
// columns (one warp, coalesced 128-byte rows) by `rows_per_split` rows, its 8
// thread rows fold strided rows, and it writes one partial per column; a
// second small kernel folds the `splits` partials in a fixed order and
// finalizes (ℓ2: √). No atomics, so sums are deterministic. The split count
// comes from kernels/codegen/tiling.py:row_split so that a bi-level item of
// 8192 x 2048 (64 column tiles) still spreads over the 132 SMs.
//
// Bound: bytes. Y is read once (the lead folds and the row fold happen in
// registers), the aggregates are written once; O(1) operations per element.
#include "common.cuh"

namespace {

constexpr int BM = 32;  // columns per CTA (tiling.BLOCK_M)
constexpr int BR = 8;   // thread rows per CTA (tiling.BLOCK_ROWS)

template <int LEAD>
__global__ void __launch_bounds__(BM * BR)
reduce_partial(const float* __restrict__ y, float* __restrict__ v1,
               float* __restrict__ v2, float* __restrict__ partial, int g1,
               int g2, int n, int m, int q1, int q2, int qlast,
               int rows_per_split, int splits) {
  __shared__ float red[BR][BM];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * BM + tx;
  const int split = blockIdx.y;
  const long long b = blockIdx.z;
  const long long nm = static_cast<long long>(n) * m;
  const int r0 = split * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);

  float acc = 0.f;  // identity of every monoid on non-negative values
  if (j < m) {
    const float* yb = y + b * g1 * g2 * nm;
    // unrolled loops keep several independent loads in flight per thread
#pragma unroll 4
    for (int i = r0 + ty; i < r1; i += BR) {
      const long long ij = static_cast<long long>(i) * m + j;
      float cur;
      if (LEAD == 0) {
        cur = fabsf(yb[ij]);
      } else if (LEAD == 1) {
        float a = 0.f;
#pragma unroll 4
        for (int l1 = 0; l1 < g1; ++l1) a = fold(q1, a, fabsf(yb[l1 * nm + ij]));
        cur = finalize(q1, a);
        v1[b * nm + ij] = cur;
      } else {
        float c = 0.f;
        for (int l2 = 0; l2 < g2; ++l2) {
          float a = 0.f;
#pragma unroll 4
          for (int l1 = 0; l1 < g1; ++l1)
            a = fold(q1, a, fabsf(yb[(static_cast<long long>(l1) * g2 + l2) * nm + ij]));
          a = finalize(q1, a);
          v1[(b * g2 + l2) * nm + ij] = a;
          c = fold(q2, c, a);
        }
        cur = finalize(q2, c);
        v2[b * nm + ij] = cur;
      }
      acc = fold(qlast, acc, cur);
    }
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < m) {
    float s = red[0][tx];
    for (int k = 1; k < BR; ++k) s = combine(qlast, s, red[k][tx]);
    partial[(b * splits + split) * m + j] = s;
  }
}

__global__ void reduce_finalize(const float* __restrict__ partial,
                                float* __restrict__ vfin, int m, int splits,
                                int qlast, int raw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (j >= m) return;
  const float* p = partial + b * splits * m + j;
  float s = p[0];
  for (int k = 1; k < splits; ++k) s = combine(qlast, s, p[static_cast<long long>(k) * m]);
  vfin[b * m + j] = raw ? s : finalize(qlast, s);
}

}  // namespace

// y: (batch, g1, g2, n, m) contiguous float32 (g1 = g2 = 1 for absent lead
// axes); v1/v2 may be null when LEAD does not produce them; partial:
// (batch, splits, m) scratch; vfin: (batch, m), finalized unless `raw`.
// Returns a cudaError_t.
REPRO_EXPORT int codegen_reduce(const float* y, float* v1, float* v2,
                                float* partial, float* vfin, int batch,
                                int lead_rank, int g1, int g2, int n, int m,
                                int q1, int q2, int qlast, int rows_per_split,
                                int splits, int raw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BM, BR);
  const dim3 grid((m + BM - 1) / BM, splits, batch);
  switch (lead_rank) {
    case 0:
      reduce_partial<0><<<grid, block, 0, s>>>(y, v1, v2, partial, g1, g2, n, m,
                                               q1, q2, qlast, rows_per_split, splits);
      break;
    case 1:
      reduce_partial<1><<<grid, block, 0, s>>>(y, v1, v2, partial, g1, g2, n, m,
                                               q1, q2, qlast, rows_per_split, splits);
      break;
    case 2:
      reduce_partial<2><<<grid, block, 0, s>>>(y, v1, v2, partial, g1, g2, n, m,
                                               q1, q2, qlast, rows_per_split, splits);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 fgrid((m + 255) / 256, batch);
  reduce_finalize<<<fgrid, 256, 0, s>>>(partial, vfin, m, splits, qlast, raw);
  return cudaGetLastError();
}
