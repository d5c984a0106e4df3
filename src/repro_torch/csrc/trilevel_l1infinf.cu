// trilevel_l1infinf.cu — the two streaming passes of the tri-level
// ℓ1,∞,∞ projection (paper Algorithm 5), written by hand:
//
//   reduce:  v2[i, j] = max_c |Y[c, i, j]|  and  v1[j] = max_i v2[i, j]
//            in one pass over Y (c, n, m)
//   apply:   X = clip(Y, ±min(v2, u1)), the grouped threshold apply
//            (u1 (m,) in Y's type, min taken in Y's type)
//
// Replaces the TPU kernels of repro/kernels/trilevel_l1infinf.py:
// trilevel_reduce_pallas (_reduce_kernel) and trilevel_apply_pallas
// (_apply_kernel). Y is float32 or bf16; every output is in Y's type and
// equals its plain version exactly (maxima, minima and clips do not round).
//
// Bound: bytes (O(1) operations per element). reduce reads Y once and
// writes v2 and v1; apply reads Y, v2 and u1 once and writes X once.
//
// Pallas kept the whole slice axis c of a (c, block_n, block_m) tile in
// VMEM and carried v1 across row blocks on a sequential grid axis. Here a
// thread owns VEC neighbouring columns of one row (16-byte loads, the row
// contiguous across the warp) and walks the c slices at a stride of n · m,
// so v2 never leaves registers before its one store; rows are split across
// CTAs as in bilevel_l1inf.cu and golden::fold_splits folds the per-CTA
// partial maxima into v1 in a fixed order. With few rows and many slices,
// as at (256, 32, 2048), one thread per (row, columns) would fill 64 CTAs,
// so `groups` thread rows share a row's slices (a CTA steps over
// BR / groups rows at a time) and fold them through shared memory. apply
// computes min(v2, u1) once per (row, column) and clips its share of the c
// slices; the slice axis is split across CTAs (grid z) when rows and
// columns alone give too few CTAs, as at (256, 32, 2048). Ragged column
// tails take VEC = 1.
#include "golden.cuh"

namespace {

using namespace golden;

template <typename S, int VEC>
__global__ void __launch_bounds__(BM * BR)
reduce_partial(const S* __restrict__ y, S* __restrict__ v2,
               float* __restrict__ partial, int c, int n, int m,
               int rows_per_split, int groups) {
  __shared__ float red[BR][BM * VEC];
  const int col0 = blockIdx.x * BM * VEC;
  const int j0 = col0 + threadIdx.x * VEC;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const long long nm = static_cast<long long>(n) * m;
  // thread row ty takes row `ty / groups` of each step and every
  // `groups`-th slice from `ty % groups`
  const int rows_per_step = BR / groups;
  const int lsub = threadIdx.y % groups;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;  // identity of the max on |y|
  for (int i0 = r0; i0 < r1; i0 += rows_per_step) {  // same trip count CTA-wide
    const int i = i0 + threadIdx.y / groups;
    const long long ij = static_cast<long long>(i) * m + j0;
    float a[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = 0.f;
    if (j0 < m && i < r1) {  // VEC > 1 only when m % VEC == 0
      // unrolled so that several slices' loads are in flight per thread
#pragma unroll 8
      for (int l = lsub; l < c; l += groups) {
        const Pack<S, VEC> p = load<S, VEC>(y + l * nm + ij);
#pragma unroll
        for (int k = 0; k < VEC; ++k) a[k] = max_nan(a[k], fabsf(widen(p.v[k])));
      }
    }
    if (groups > 1) {  // fold the slice groups of each row (uniform branch)
#pragma unroll
      for (int k = 0; k < VEC; ++k) red[threadIdx.y][threadIdx.x * VEC + k] = a[k];
      __syncthreads();
      if (lsub == 0) {
        for (int g = 1; g < groups; ++g) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            a[k] = max_nan(a[k], red[threadIdx.y + g][threadIdx.x * VEC + k]);
        }
      }
      __syncthreads();
    }
    if (lsub == 0 && j0 < m && i < r1) {
      Pack<S, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o.v[k] = narrow<S>(a[k]);
        acc[k] = max_nan(acc[k], a[k]);
      }
      store<S, VEC>(v2 + ij, o);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[threadIdx.y][threadIdx.x * VEC + k] = acc[k];
  write_partial<VEC>(red, partial + static_cast<long long>(blockIdx.y) * m,
                     col0, m);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(BM * BR)
apply_kernel(const S* __restrict__ y, const S* __restrict__ v2,
             const S* __restrict__ u1, S* __restrict__ x, int c, int n, int m,
             int rows_per_cta, int slices_per_cta) {
  const int j0 = (blockIdx.x * BM + threadIdx.x) * VEC;
  if (j0 >= m) return;
  const Pack<S, VEC> up = load<S, VEC>(u1 + j0);
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(n, r0 + rows_per_cta);
  const int l0 = blockIdx.z * slices_per_cta;
  const int l1 = min(c, l0 + slices_per_cta);
  const long long nm = static_cast<long long>(n) * m;
  for (int i = r0 + threadIdx.y; i < r1; i += BR) {
    const long long ij = static_cast<long long>(i) * m + j0;
    const Pack<S, VEC> vp = load<S, VEC>(v2 + ij);
    float r[VEC];  // the (i, j) ∞-radius of the recursion
#pragma unroll
    for (int k = 0; k < VEC; ++k) r[k] = min_nan(widen(vp.v[k]), widen(up.v[k]));
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      Pack<S, VEC> p = load<S, VEC>(y + l * nm + ij);
#pragma unroll
      for (int k = 0; k < VEC; ++k) p.v[k] = narrow<S>(clip_nan(widen(p.v[k]), r[k]));
      store<S, VEC>(x + l * nm + ij, p);
    }
  }
}

template <typename S, int VEC>
cudaError_t reduce_launch(const void* y, void* v2, float* partial, void* v1,
                          int c, int n, int m, int rows_per_split, int splits,
                          int groups, cudaStream_t s) {
  if (groups < 1 || BR % groups != 0) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(m, BM * VEC), splits);
  reduce_partial<S, VEC><<<grid, dim3(BM, BR), 0, s>>>(
      static_cast<const S*>(y), static_cast<S*>(v2), partial, c, n, m,
      rows_per_split, groups);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fold_splits<S><<<ceil_div(m, BM), dim3(BM, BR), 0, s>>>(
      partial, static_cast<S*>(v1), m, splits);
  return cudaGetLastError();
}

template <typename S, int VEC>
cudaError_t apply_launch(const void* y, const void* v2, const void* u1, void* x,
                         int c, int n, int m, int rows_per_cta, int row_ctas,
                         int slices_per_cta, int slice_ctas, cudaStream_t s) {
  const dim3 grid(ceil_div(m, BM * VEC), row_ctas, slice_ctas);
  apply_kernel<S, VEC><<<grid, dim3(BM, BR), 0, s>>>(
      static_cast<const S*>(y), static_cast<const S*>(v2),
      static_cast<const S*>(u1), static_cast<S*>(x), c, n, m, rows_per_cta,
      slices_per_cta);
  return cudaGetLastError();
}

}  // namespace

// v2 (n, m) and v1 (m,) of y (c, n, m); `partial` is float32 scratch of
// (splits, m). `vec` is 1 or 16 / sizeof(element); `groups` (1, 2, 4 or 8)
// thread rows share each row's slices.
REPRO_EXPORT int golden_trilevel_reduce(const void* y, void* v2, float* partial,
                                        void* v1, int dtype, int vec, int c,
                                        int n, int m, int rows_per_split,
                                        int splits, int groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return vec > 1 ? reduce_launch<float, 4>(y, v2, partial, v1, c, n, m, rows_per_split, splits, groups, s)
                   : reduce_launch<float, 1>(y, v2, partial, v1, c, n, m, rows_per_split, splits, groups, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? reduce_launch<bf16_bits, 8>(y, v2, partial, v1, c, n, m, rows_per_split, splits, groups, s)
                   : reduce_launch<bf16_bits, 1>(y, v2, partial, v1, c, n, m, rows_per_split, splits, groups, s);
  return cudaErrorInvalidValue;
}

// x (c, n, m) = clip(y, ±min(v2, u1)); v2 (n, m) and u1 (m,) in y's type.
REPRO_EXPORT int golden_trilevel_apply(const void* y, const void* v2,
                                       const void* u1, void* x, int dtype,
                                       int vec, int c, int n, int m,
                                       int rows_per_cta, int row_ctas,
                                       int slices_per_cta, int slice_ctas,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return vec > 1 ? apply_launch<float, 4>(y, v2, u1, x, c, n, m, rows_per_cta, row_ctas, slices_per_cta, slice_ctas, s)
                   : apply_launch<float, 1>(y, v2, u1, x, c, n, m, rows_per_cta, row_ctas, slices_per_cta, slice_ctas, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? apply_launch<bf16_bits, 8>(y, v2, u1, x, c, n, m, rows_per_cta, row_ctas, slices_per_cta, slice_ctas, s)
                   : apply_launch<bf16_bits, 1>(y, v2, u1, x, c, n, m, rows_per_cta, row_ctas, slices_per_cta, slice_ctas, s);
  return cudaErrorInvalidValue;
}
