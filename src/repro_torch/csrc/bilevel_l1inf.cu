// bilevel_l1inf.cu — the two streaming passes of the bi-level ℓ1,∞
// projection (paper Algorithm 2), written by hand:
//
//   colmax:  v[j] = max_i |Y[i, j]|          (Y (n, m) -> v (m,))
//   clip:    X[i, j] = clip(Y[i, j], ±u[j])  (u (m,) in Y's type)
//
// Replaces the TPU kernels of repro/kernels/bilevel_l1inf.py: colmax_pallas
// (_colmax_kernel) and clip_pallas (_clip_kernel). Y is float32 or bf16; both
// outputs are in Y's type and equal their plain versions exactly (maxima and
// clips do not round).
//
// Bound: bytes (O(1) operations per element). colmax reads Y once and
// writes m values; clip reads Y once and writes X once.
//
// Pallas carried the column max across row blocks on a sequential grid
// axis. Hopper runs CTAs in no order, and one CTA per column strip would
// leave most of the 132 SMs idle (8 CTAs at 8192 x 2048), so the rows are
// split too: a CTA covers BM * VEC columns — each thread VEC neighbouring
// columns, one 16-byte load per row — by `rows_per_split` rows, its BR
// thread rows walk strided rows, and it writes one partial row of maxima;
// golden::fold_splits folds the partial rows in a fixed order. Max is exact
// and the order is fixed, so the result is deterministic. clip uses the same
// (column strip, row chunk) grid and keeps its VEC radii in registers.
// Ragged column tails take VEC = 1 (the wrapper picks VEC); ragged row tails
// end each thread's loop.
#include "golden.cuh"

namespace {

using namespace golden;

template <typename S, int VEC>
__global__ void __launch_bounds__(BM * BR)
colmax_partial(const S* __restrict__ y, float* __restrict__ partial, int n,
               int m, int rows_per_split) {
  __shared__ float red[BR][BM * VEC];
  const int col0 = blockIdx.x * BM * VEC;
  const int j0 = col0 + threadIdx.x * VEC;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;  // identity of the max on |y|
  if (j0 < m) {  // VEC > 1 only when m % VEC == 0: the whole pack is valid
#pragma unroll 4
    for (int i = r0 + threadIdx.y; i < r1; i += BR) {
      const Pack<S, VEC> p = load<S, VEC>(y + static_cast<long long>(i) * m + j0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], fabsf(widen(p.v[k])));
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[threadIdx.y][threadIdx.x * VEC + k] = acc[k];
  write_partial<VEC>(red, partial + static_cast<long long>(blockIdx.y) * m,
                     col0, m);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(BM * BR)
clip_kernel(const S* __restrict__ y, const S* __restrict__ u,
            S* __restrict__ x, int n, int m, int rows_per_cta) {
  const int j0 = (blockIdx.x * BM + threadIdx.x) * VEC;
  if (j0 >= m) return;
  const Pack<S, VEC> up = load<S, VEC>(u + j0);
  float hi[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) hi[k] = widen(up.v[k]);
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(n, r0 + rows_per_cta);
#pragma unroll 4
  for (int i = r0 + threadIdx.y; i < r1; i += BR) {
    const long long off = static_cast<long long>(i) * m + j0;
    Pack<S, VEC> p = load<S, VEC>(y + off);
#pragma unroll
    for (int k = 0; k < VEC; ++k) p.v[k] = narrow<S>(clip_nan(widen(p.v[k]), hi[k]));
    store<S, VEC>(x + off, p);
  }
}

template <typename S, int VEC>
cudaError_t colmax_launch(const void* y, float* partial, void* out, int n,
                          int m, int rows_per_split, int splits,
                          cudaStream_t s) {
  const dim3 grid(ceil_div(m, BM * VEC), splits);
  colmax_partial<S, VEC><<<grid, dim3(BM, BR), 0, s>>>(
      static_cast<const S*>(y), partial, n, m, rows_per_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fold_splits<S><<<ceil_div(m, BM), dim3(BM, BR), 0, s>>>(
      partial, static_cast<S*>(out), m, splits);
  return cudaGetLastError();
}

template <typename S, int VEC>
cudaError_t clip_launch(const void* y, const void* u, void* x, int n, int m,
                        int rows_per_cta, int row_ctas, cudaStream_t s) {
  const dim3 grid(ceil_div(m, BM * VEC), row_ctas);
  clip_kernel<S, VEC><<<grid, dim3(BM, BR), 0, s>>>(
      static_cast<const S*>(y), static_cast<const S*>(u), static_cast<S*>(x),
      n, m, rows_per_cta);
  return cudaGetLastError();
}

}  // namespace

// v (m,) = column max of |y| (n, m); `partial` is float32 scratch of
// (splits, m). `vec` is 1 or 16 / sizeof(element).
REPRO_EXPORT int golden_colmax(const void* y, float* partial, void* out,
                               int dtype, int vec, int n, int m,
                               int rows_per_split, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return vec > 1 ? colmax_launch<float, 4>(y, partial, out, n, m, rows_per_split, splits, s)
                   : colmax_launch<float, 1>(y, partial, out, n, m, rows_per_split, splits, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? colmax_launch<bf16_bits, 8>(y, partial, out, n, m, rows_per_split, splits, s)
                   : colmax_launch<bf16_bits, 1>(y, partial, out, n, m, rows_per_split, splits, s);
  return cudaErrorInvalidValue;
}

// x (n, m) = clip(y, ±u) with u (m,) in y's type.
REPRO_EXPORT int golden_clip(const void* y, const void* u, void* x, int dtype,
                             int vec, int n, int m, int rows_per_cta,
                             int row_ctas, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return vec > 1 ? clip_launch<float, 4>(y, u, x, n, m, rows_per_cta, row_ctas, s)
                   : clip_launch<float, 1>(y, u, x, n, m, rows_per_cta, row_ctas, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? clip_launch<bf16_bits, 8>(y, u, x, n, m, rows_per_cta, row_ctas, s)
                   : clip_launch<bf16_bits, 1>(y, u, x, n, m, rows_per_cta, row_ctas, s);
  return cudaErrorInvalidValue;
}
