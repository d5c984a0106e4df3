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
// VMEM and carried v1 across row blocks on a sequential grid axis. Hopper
// runs CTAs in no order; here a strip of `packs` packs of VEC neighbouring
// columns (one 16-byte load per row and slice each) belongs to one thread
// block cluster of up to 8 CTAs, and one launch writes v2 and v1 with no
// partial maxima in device memory and no second kernel. Thread t of a CTA
// of cluster rank r owns pack t % packs and lane r · lanes + t / packs of
// the cluster; the lanes cut into row slots of `groups` lanes each, and
// the lanes of a slot take every groups-th slice of its rows
// (REDUCE_LOADS loads in flight), so a request with few rows and many
// slices, as (256, 32, 2048), still fills every lane, and one with many
// rows, as (32, 1000, 2000), spreads them over the cluster. The groups of
// a row fold by butterfly inside the warp (packs · groups <= 32) and the
// first stores the row's v2 once. Every lane folds its rows into a running
// max; the CTA folds its lanes (butterfly inside each warp, then the warps
// through shared memory), and after a cluster barrier each CTA folds its
// share of the strip's columns over the cluster's CTAs, in rank order,
// through distributed shared memory into v1. The wrapper
// (kernels/trilevel_l1infinf.py:reduce_shape) takes the widest strip, up
// to 512 bytes of a row, whose clusters fill the card and whose rows keep
// the lanes busy: on an H100, 512-byte strips in clusters of 8 read W4's
// (32, 1000, 2000) float32 as fast as the two-kernel row-split reduce
// they replace, where 64-byte strips of one CTA each took 1.28 times as
// long (PERF.md § 6). Max is exact and order-free, NaN included (max_nan), so
// the result is deterministic. apply streams Y's c planes as runs of packs
// (golden.cuh: stream_clip): each CTA holds min(v2, u1) of its 8 KB tile
// of the plane in registers across a group of planes, so v2 is read once
// per group; the wrapper (kernels/bilevel_l1inf.py:stream_shape) picks the
// groups.
#include <cooperative_groups.h>

#include "golden.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace golden;

constexpr int REDUCE_THREADS = 512;  // trilevel_l1infinf.REDUCE_THREADS
constexpr int REDUCE_MIN_CTAS = 1;   // CTAs resident per SM (one wave:
                                     // trilevel_l1infinf.REDUCE_CTAS)
constexpr int REDUCE_LOADS = 8;      // slices in flight per thread
constexpr int REDUCE_CLUSTER_MAX = 8;  // the portable cluster size
constexpr int WARP = 32;

template <typename S, int VEC>
__global__ void __launch_bounds__(REDUCE_THREADS, REDUCE_MIN_CTAS)
trilevel_reduce_kernel(const S* __restrict__ y, S* __restrict__ v2,
                       S* __restrict__ v1, int c, int n, int m, int packs,
                       int groups) {
  __shared__ float red[REDUCE_THREADS * VEC];
  const cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int lanes = REDUCE_THREADS / packs;             // per CTA
  const int p = t % packs, lane = rank * lanes + t / packs;  // across the cluster
  const int g = lane % groups, slot = lane / groups;
  const int slots = cl * lanes / groups;                // rows per step
  const int strip = blockIdx.x / cl;
  const int j0 = (strip * packs + p) * VEC;
  const long long nm = static_cast<long long>(n) * m;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;  // identity of the max on |y|
  // the same trip count CTA-wide: every lane reaches the shuffles below
  for (int i0 = 0; i0 < n; i0 += slots) {
    const int i = i0 + slot;
    const bool owns = j0 < m && i < n;  // VEC > 1 only when m % VEC == 0
    float a[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = 0.f;
    if (owns) {
      const S* yij = y + static_cast<long long>(i) * m + j0;
      // slices g, g + groups, …: batches of REDUCE_LOADS loads issued before
      // fold; a ragged tail is one predicated batch (0 past slice c)
      Pack<S, VEC> x[REDUCE_LOADS];
      int l = g;
      for (; l + (REDUCE_LOADS - 1) * groups < c; l += REDUCE_LOADS * groups) {
#pragma unroll
        for (int u = 0; u < REDUCE_LOADS; ++u)
          x[u] = load<S, VEC>(yij + (l + u * groups) * nm);
        fold_abs_max<S, VEC, REDUCE_LOADS>(a, x);
      }
      if (l < c) {
#pragma unroll
        for (int u = 0; u < REDUCE_LOADS; ++u)
          x[u] = l + u * groups < c ? load<S, VEC>(yij + (l + u * groups) * nm)
                                    : Pack<S, VEC>{};
        fold_abs_max<S, VEC, REDUCE_LOADS>(a, x);
      }
    }
    // the groups of row i: lanes packs, 2·packs, … apart in one warp
    for (int o = packs; o < packs * groups; o <<= 1)
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = max_nan(a[k], __shfl_xor_sync(0xffffffffu, a[k], o));
    if (owns && g == 0) {
      Pack<S, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) o.v[k] = narrow<S>(a[k]);
      store<S, VEC>(v2 + static_cast<long long>(i) * m + j0, o);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], a[k]);
  }
  // v1: the row slots inside a warp (a slot's lanes already agree), then
  // the warps (or, with packs > 32, the lanes) through shared memory
  for (int o = packs * groups; o < WARP; o <<= 1)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], o));
  const int span = max(WARP, packs), width = packs * VEC;
  if (t % span < packs) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[(t / span) * width + p * VEC + k] = acc[k];
  }
  __syncthreads();
  // the CTA's partial of each column into red[0, width) (column q is read
  // and written by thread q alone), then across the cluster: CTA `rank`
  // folds columns rank, rank + cl, … of every CTA's partial in rank order
  // through distributed shared memory and writes them to v1
  for (int q = t; q < width; q += REDUCE_THREADS) {
    float a = red[q];
    for (int w = 1; w < REDUCE_THREADS / span; ++w) a = max_nan(a, red[w * width + q]);
    red[q] = a;
  }
  cluster.sync();
  const int col0 = strip * width;
  for (int q = rank + t * cl; q < width && col0 + q < m; q += REDUCE_THREADS * cl) {
    float a = 0.f;
    for (int r = 0; r < cl; ++r) a = max_nan(a, cluster.map_shared_rank(red, r)[q]);
    v1[col0 + q] = narrow<S>(a);
  }
  cluster.sync();  // every CTA's partial stays until the cluster has read it
}

// apply's radius: min(v2[i, j], u1[j]) of the element at plane offset f
// = i · m + j, taken in Y's type (min_nan returns one of its operands)
template <typename S, int VEC>
struct GroupRadius {
  const S* __restrict__ v2;
  const S* __restrict__ u1;
  int m;
  __device__ Pack<S, VEC> pack(long long f, int j) const {
    Pack<S, VEC> r = load_stream<S, VEC>(v2 + f);
    const Pack<S, VEC> u = column_radius<S, VEC>(u1, j, m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = narrow<S>(min_nan(widen(r.v[k]), widen(u.v[k])));
    return r;
  }
  __device__ float one(long long e, int j) const {
    return min_nan(widen(v2[e]), widen(u1[j]));
  }
};

template <typename S, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS, stream_min_ctas<S>())
apply_kernel(const S* __restrict__ y, const S* __restrict__ v2,
             const S* __restrict__ u1, S* __restrict__ x, int c, int m,
             long long plane, int groups) {
  stream_clip<S, VEC>(y, x, GroupRadius<S, VEC>{v2, u1, m}, c, m, plane,
                      groups);
}

template <typename S, int VEC>
cudaError_t reduce_launch(const void* y, void* v2, void* v1, int c, int n,
                          int m, int packs, int groups, int cluster,
                          cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(m / VEC, packs) * cluster);
  cfg.blockDim = dim3(REDUCE_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, trilevel_reduce_kernel<S, VEC>,
                            static_cast<const S*>(y), static_cast<S*>(v2),
                            static_cast<S*>(v1), c, n, m, packs, groups);
}

template <typename S, int VEC>
cudaError_t apply_launch(const void* y, const void* v2, const void* u1, void* x,
                         int c, int n, int m, int groups, cudaStream_t s) {
  const long long plane = static_cast<long long>(n) * m;
  const long long ctas = stream_ctas(plane, VEC, groups);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  apply_kernel<S, VEC><<<static_cast<unsigned>(ctas), STREAM_THREADS, 0, s>>>(
      static_cast<const S*>(y), static_cast<const S*>(v2),
      static_cast<const S*>(u1), static_cast<S*>(x), c, m, plane, groups);
  return cudaGetLastError();
}

}  // namespace

// v2 (n, m) and v1 (m,) of y (c, n, m), in y's type. `vec` is 1 or
// 16 / sizeof(element); `packs` (a power of two dividing REDUCE_THREADS)
// column packs per strip; `cluster` (1, 2, 4 or 8) CTAs per strip, one
// thread block cluster; `groups` (a power of two, packs · groups <= 32
// when above 1) lanes share each row's slices.
REPRO_EXPORT int golden_trilevel_reduce(const void* y, void* v2, void* v1,
                                        int dtype, int vec, int c, int n,
                                        int m, int packs, int groups,
                                        int cluster, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packs < 1 || packs > REDUCE_THREADS || REDUCE_THREADS % packs ||
      groups < 1 || (groups & (groups - 1)) ||
      (groups > 1 && packs * groups > WARP) ||
      cluster < 1 || cluster > REDUCE_CLUSTER_MAX || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return vec > 1 ? reduce_launch<float, 4>(y, v2, v1, c, n, m, packs, groups, cluster, s)
                   : reduce_launch<float, 1>(y, v2, v1, c, n, m, packs, groups, cluster, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? reduce_launch<bf16_bits, 8>(y, v2, v1, c, n, m, packs, groups, cluster, s)
                   : reduce_launch<bf16_bits, 1>(y, v2, v1, c, n, m, packs, groups, cluster, s);
  return cudaErrorInvalidValue;
}

// x (c, n, m) = clip(y, ±min(v2, u1)); v2 (n, m) and u1 (m,) in y's type.
// `vec` is 1 or 16 / sizeof(element) (every pointer and every plane of y
// 16-byte aligned); `groups` (1 to c) groups of planes.
REPRO_EXPORT int golden_trilevel_apply(const void* y, const void* v2,
                                       const void* u1, void* x, int dtype,
                                       int vec, int c, int n, int m,
                                       int groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > c || n < 1 || m < 1) return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return vec > 1 ? apply_launch<float, 4>(y, v2, u1, x, c, n, m, groups, s)
                   : apply_launch<float, 1>(y, v2, u1, x, c, n, m, groups, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? apply_launch<bf16_bits, 8>(y, v2, u1, x, c, n, m, groups, s)
                   : apply_launch<bf16_bits, 1>(y, v2, u1, x, c, n, m, groups, s);
  return cudaErrorInvalidValue;
}
