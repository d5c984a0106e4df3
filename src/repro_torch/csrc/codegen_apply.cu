// codegen_apply.cu — the backward sweep of a norm design fused into one
// elementwise pass over Y, for a batch of items.
//
// Replaces the generated TPU apply kernels of
// repro/kernels/codegen/lowering.py: _apply_call (_make_apply_kernel with
// _apply_tile, _apply_chain, _grouped_l1_tile), _apply_call_batched
// (_make_batched_apply_kernel) and _partial_apply_call
// (_make_partial_apply_kernel).
//
// Same canonical layout as codegen_reduce.cu. The radii chain starts at the
// solved aggregate u (B, m) and walks down per column j and row i:
//   level L-1 (`qlast`) on x = Y (LEAD 0), v1 (LEAD 1) or v2 (LEAD 2):
//     ℓ∞ clip to ±u[j]; ℓ2 rescale by u[j] / vfin[j] when vfin[j] > u[j];
//     ℓ1 soft threshold by the column's θ_j (64-step bisection over n);
//   level 2 (q2, LEAD 2) over the l2 group of v1, level 1 (q1) over the l1
//   group of Y, with the same three rules; an ℓ1 group's θ comes from a
//   64-step bisection run by the thread that owns the group.
// ℓ2 rescales use the saved aggregates, never recomputed norms, and the
// 1e-30 floor keeps an all-zero group out of 0/0. θ = 0 when Σ|x| <= r.
// Every level keeps the plain version's NaN rules (torch.maximum,
// torch.minimum and torch.clamp propagate NaN; fmaxf would drop it), the ℓ1
// bisections included (see group_theta), so a NaN or ±inf in Y lands where
// the plain version puts it.
//
// codegen_partial_apply resumes that chain one level down: the mesh
// executor (kernels/codegen/distributed.py) solves level L-1's ℓ1 groups,
// which span several ranks, with a distributed bisection and hands over
// their radii w, shaped like the last lead aggregate (B, n, m). The kernel
// reads w[b, i, j] where apply_kernel computes it and runs the same chain
// (LEAD 1 or 2, designs of depth 3 and 4). One thread per (b, i, j) and its
// lead group, rows split across CTAs as in the non-resident apply; no
// shared memory, since no level-(L-1) group has to be resident.
//
// An ℓ1 apply at level L-1 needs a whole column in one CTA (the n_resident
// pin of kernels/codegen/tiling.py): the CTA stages |x| of its 32 columns in
// shared memory (n x 32 floats, bounded by tiling.SMEM_BUDGET_BYTES), its 8
// thread rows bisect with column reductions through shared memory, and
// splits == 1. Otherwise rows split across CTAs like the reduce pass.
// Each element is read and written by one thread, so `out` may alias `y`.
//
// Lead groups that are independent per element (every lead level ℓ∞ or ℓ2,
// and level L-1 not ℓ1) take split_apply_kernel instead: once w(i, j) is
// known each element of the group shrinks alone, so the lead slices split
// across grid z (tiling.lead_split: enough CTAs to fill the card, where the
// row split alone gave 256 CTAs to the (256, 32, 2048) tri-level request)
// and a thread owns VEC = 4 adjacent columns of one row, 16-byte loads.
// Ragged m or unaligned pointers take VEC = 1. An ℓ1 lead group needs the
// whole group for its θ and keeps apply_kernel's thread-serial bisection.
//
// Bound: bytes. Y is read once and X written once; the aggregates (and w)
// add 1/g of that per lead level. A lead aggregate that only an ℓ2 shrink
// needs (v1 under LEAD 1, v2 under LEAD 2) is read only for ℓ2, and vfin
// only for an ℓ2 at level L-1. O(1) operations per element outside ℓ1
// groups, 64 sweeps over the group per ℓ1 level (served from shared memory
// or L1/L2, not HBM).
#include "common.cuh"

namespace {

constexpr int BM = 32;  // columns per CTA (tiling.BLOCK_M)
constexpr int BR = 8;   // thread rows per CTA (tiling.BLOCK_ROWS)
constexpr int ITERS = 64;

// An ℓ1 group's θ follows kernels/l1ball.py:project_l1_plain (:46-83) on
// non-finite input too, with common.cuh's NaN-propagating max (max_nan) where
// the plain version has amax, sum or clamp:
//   s = Σ|x| and hi = max|x| are NaN when the group holds a NaN and +inf when
//   it holds ±inf (:51, :55); "inside" is s <= r, false for a NaN s or r (:52);
//   each step's φ = Σ max_nan(|x| - mid, 0) (:58, torch.clamp keeps NaN), so
//   hi = +inf gives mid = +inf, φ = NaN (inf - inf), φ > r false and
//   θ = (0 + inf) / 2 = +inf; a NaN hi gives θ = NaN;
//   the shrink sgn(x) · max_nan(|x| - θ, 0) (:83) then puts NaN on every
//   element of a group with a NaN θ, and on the ±inf elements of a group
//   with θ = +inf (its finite elements go to 0).
// The comparisons (s <= r, φ > r) are the plain version's, false on NaN.

// One group's ℓ1 θ, thread-serial over `len` values at `stride`
// (lowering.py:_grouped_l1_tile): bisection on [0, max|x|], step for step
// the plain version's (kernels/l1ball.py:project_l1_plain).
__device__ float group_theta(const float* x, long long stride, int len, float r) {
  float hi = 0.f, s = 0.f;
  for (int k = 0; k < len; ++k) {
    const float a = fabsf(x[k * stride]);
    hi = max_nan(hi, a);
    s += a;
  }
  if (s <= r) return 0.f;  // inside the ball: identity
  float lo = 0.f;
  for (int it = 0; it < ITERS; ++it) {
    const float mid = 0.5f * (lo + hi);
    float phi = 0.f;
    for (int k = 0; k < len; ++k) phi += max_nan(fabsf(x[k * stride]) - mid, 0.f);
    if (phi > r) lo = mid; else hi = mid;
  }
  return 0.5f * (lo + hi);
}

// Shrink one element x of a group with norm q to radius w: ℓ∞ clip, ℓ2
// rescale by the group's saved aggregate, ℓ1 soft threshold by θ.
__device__ __forceinline__ float shrink(int q, float x, float w, float agg,
                                        float theta) {
  if (q == NORM_LINF) return min_nan(max_nan(x, -w), w);
  if (q == NORM_L2) return agg > w ? x * (w / fmaxf(agg, 1e-30f)) : x;
  // sign(x) * max(|x| - θ, 0), NaN kept as torch.sign(x) * torch.clamp does
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * max_nan(fabsf(x) - theta, 0.f);
}

// dst[k·stride] = shrink(src[k·stride]) for k < len. `dst` may alias `src`,
// so the compiler may not move a load above an earlier store; loading UNROLL
// elements before storing them keeps UNROLL loads in flight per thread
// (each element is still loaded before it is stored).
constexpr int UNROLL = 4;
__device__ __forceinline__ void shrink_strided(int q, const float* src,
                                               float* dst, long long stride,
                                               int len, float w, float agg,
                                               float theta) {
  int k = 0;
  for (; k + UNROLL <= len; k += UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = src[(k + u) * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[(k + u) * stride] = shrink(q, x[u], w, agg, theta);
  }
  for (; k < len; ++k) dst[k * stride] = shrink(q, src[k * stride], w, agg, theta);
}

// Levels L-2 … 1 of the chain at position ij of item b, from the radius w
// of level L-1 there: LEAD 1 shrinks Y's group over l1 (aggregate v1);
// LEAD 2 shrinks v1's group over l2 (aggregate v2), then Y's group over l1
// under each of its members.
template <int LEAD>
__device__ __forceinline__ void lead_chain(const float* y, const float* v1,
                                           const float* v2, float* out,
                                           long long b, long long ij,
                                           long long nm, int g1, int g2,
                                           int q1, int q2, float w) {
  if (LEAD == 1) {
    const long long base = b * g1 * nm + ij;  // group over l1, stride nm
    // only an ℓ2 shrink reads the group's saved aggregate
    const float agg = q1 == NORM_L2 ? v1[b * nm + ij] : 0.f;
    const float th = q1 == NORM_L1 ? group_theta(y + base, nm, g1, w) : 0.f;
    shrink_strided(q1, y + base, out + base, nm, g1, w, agg, th);
  } else if (LEAD == 2) {
    const float* v1g = v1 + b * g2 * nm + ij;  // group over l2, stride nm
    const float agg2 = q2 == NORM_L2 ? v2[b * nm + ij] : 0.f;
    const float th2 = q2 == NORM_L1 ? group_theta(v1g, nm, g2, w) : 0.f;
    const long long stride1 = static_cast<long long>(g2) * nm;
    for (int l2 = 0; l2 < g2; ++l2) {
      const float x1 = v1g[l2 * nm];
      const float w2 = shrink(q2, x1, w, agg2, th2);
      const long long base = (b * g1 * g2 + l2) * nm + ij;  // group over l1
      const float th1 = q1 == NORM_L1 ? group_theta(y + base, stride1, g1, w2) : 0.f;
      shrink_strided(q1, y + base, out + base, stride1, g1, w2, x1, th1);
    }
  }
}

// Fold one value per thread over the CTA's 8 thread rows of its column;
// every thread of the column gets the same result. The max keeps NaN.
template <bool MAX>
__device__ float column_reduce(float v, float (*red)[BM]) {
  __syncthreads();
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float r = red[0][threadIdx.x];
  for (int k = 1; k < BR; ++k) r = MAX ? max_nan(r, red[k][threadIdx.x]) : r + red[k][threadIdx.x];
  return r;
}

template <int LEAD>
__global__ void __launch_bounds__(BM * BR)
apply_kernel(const float* y, const float* __restrict__ v1,
             const float* __restrict__ v2, const float* __restrict__ vfin,
             const float* __restrict__ u, float* out, int g1, int g2, int n,
             int m, int q1, int q2, int qlast, int rows_per_split) {
  extern __shared__ float col[];  // ℓ1 at level L-1 only: |x| as [n][BM]
  __shared__ float red[BR][BM];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * BM + tx;
  const long long b = blockIdx.y;
  const bool valid = j < m;
  const long long nm = static_cast<long long>(n) * m;
  const float uj = valid ? u[b * m + j] : 0.f;
  const float vj = valid && qlast == NORM_L2 ? vfin[b * m + j] : 0.f;
  // input of the level-(L-1) apply: Y itself or the last lead aggregate
  const float* xs = LEAD == 0 ? y + b * nm : (LEAD == 1 ? v1 : v2) + b * nm;

  float theta = 0.f;
  if (qlast == NORM_L1) {  // whole column resident, one CTA per column tile
    float hi = 0.f, s = 0.f;
    for (int i = ty; i < n; i += BR) {
      const float a = valid ? fabsf(xs[static_cast<long long>(i) * m + j]) : 0.f;
      col[i * BM + tx] = a;
      hi = max_nan(hi, a);
      s += a;
    }
    hi = column_reduce<true>(hi, red);
    s = column_reduce<false>(s, red);
    float lo = 0.f;
    for (int it = 0; it < ITERS; ++it) {  // uniform trip count: barriers inside
      const float mid = 0.5f * (lo + hi);
      float p = 0.f;
      for (int i = ty; i < n; i += BR) p += max_nan(col[i * BM + tx] - mid, 0.f);
      const float phi = column_reduce<false>(p, red);
      if (phi > uj) lo = mid; else hi = mid;
    }
    theta = s <= uj ? 0.f : 0.5f * (lo + hi);
  }
  if (!valid) return;

  const int r0 = blockIdx.z * rows_per_split + ty;
  const int r1 = min(n, blockIdx.z * rows_per_split + rows_per_split);
  if (LEAD == 0) {  // this thread's rows r0, r0 + BR, ... of column j
    const long long ij = static_cast<long long>(r0) * m + j;
    if (r0 < r1)
      shrink_strided(qlast, xs + ij, out + b * nm + ij,
                     static_cast<long long>(BR) * m, (r1 - r0 + BR - 1) / BR,
                     uj, vj, theta);
    return;
  }
  for (int i = r0; i < r1; i += BR) {
    const long long ij = static_cast<long long>(i) * m + j;
    lead_chain<LEAD>(y, v1, v2, out, b, ij, nm, g1, g2, q1, q2,
                     shrink(qlast, xs[ij], uj, vj, theta));
  }
}

// Levels L-2 … 1 below one position: each thread owns (b, i, j) and walks
// the lead groups of column j and row i given w, the level-(L-1) radius
// there. Resumed here by codegen_partial_apply with w read from memory.
template <int LEAD>
__global__ void __launch_bounds__(BM * BR)
partial_apply_kernel(const float* y, const float* __restrict__ v1,
                     const float* __restrict__ v2, const float* __restrict__ w,
                     float* out, int g1, int g2, int n, int m, int q1, int q2,
                     int rows_per_split) {
  const int j = blockIdx.x * BM + threadIdx.x;
  if (j >= m) return;
  const long long b = blockIdx.y;
  const long long nm = static_cast<long long>(n) * m;
  const int r0 = blockIdx.z * rows_per_split + threadIdx.y;
  const int r1 = min(n, blockIdx.z * rows_per_split + rows_per_split);
  for (int i = r0; i < r1; i += BR) {
    const long long ij = static_cast<long long>(i) * m + j;
    lead_chain<LEAD>(y, v1, v2, out, b, ij, nm, g1, g2, q1, q2, w[b * nm + ij]);
  }
}

// VEC adjacent floats, one load or store of 4 · VEC bytes
template <int VEC>
struct alignas(4 * VEC) Floats {
  float v[VEC];
};
template <int VEC>
__device__ __forceinline__ Floats<VEC> load_vec(const float* p) {
  return *reinterpret_cast<const Floats<VEC>*>(p);
}
// Y and X are read and written once: streaming loads and stores
// (evict first), which keep the aggregates the other CTAs read in L2
template <int VEC>
__device__ __forceinline__ Floats<VEC> load_once(const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    return {{t.x, t.y, t.z, t.w}};
  } else {
    return {{__ldcs(p)}};
  }
}
template <int VEC>
__device__ __forceinline__ void store_once(float* p, const Floats<VEC>& x) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
  else
    __stcs(p, x.v[0]);
}

constexpr int SPLIT_THREADS = 256;  // tiling.SPLIT_THREADS

// The independent lead groups: thread p of the CTA row owns row i and the
// VEC columns j0.. of position p = i · (m / VEC) + j0 / VEC, grid y the
// item, grid z a chunk of `chunk` lead slices s = l1 · g2 + l2 (memory
// order). w(i, j) is shrunk once from the last lead aggregate (v1 under
// LEAD 1, v2 under LEAD 2); under LEAD 2 each slice's level-2 radius is
// shrunk from v1 again, one cached load per slice.
template <int LEAD, int VEC>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_apply_kernel(const float* y, const float* __restrict__ v1,
                   const float* __restrict__ v2, const float* __restrict__ vfin,
                   const float* __restrict__ u, float* out, int g1, int g2,
                   int n, int m, int q1, int q2, int qlast, int chunk) {
  const int mv = m / VEC;
  const long long p = static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (p >= static_cast<long long>(n) * mv) return;
  const int i = static_cast<int>(p / mv), j0 = static_cast<int>(p % mv) * VEC;
  const long long b = blockIdx.y, nm = static_cast<long long>(n) * m;
  const long long ij = static_cast<long long>(i) * m + j0;
  const int nslices = g1 * g2;
  const int s0 = blockIdx.z * chunk, s1 = min(nslices, s0 + chunk);
  float w[VEC];
  Floats<VEC> xa;
  for (int s = s0; s < s1; s += UNROLL) {  // UNROLL loads in flight, then stores
    const int cnt = min(UNROLL, s1 - s);
    Floats<VEC> x[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (k < cnt) x[k] = load_once<VEC>(y + (b * nslices + s + k) * nm + ij);
    if (s == s0) {  // w(i, j), its loads behind the first slices'
      // the last lead aggregate at (i, j): input of the level-(L-1) apply,
      // and the saved aggregate of the next level's ℓ2 rescale
      xa = load_vec<VEC>((LEAD == 1 ? v1 : v2) + b * nm + ij);
      const Floats<VEC> uj = load_vec<VEC>(u + b * m + j0);
      Floats<VEC> vj = {};
      if (qlast == NORM_L2) vj = load_vec<VEC>(vfin + b * m + j0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[e] = shrink(qlast, xa.v[e], uj.v[e], vj.v[e], 0.f);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (k >= cnt) break;
      Floats<VEC> r;
      if (LEAD == 1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) r.v[e] = shrink(q1, x[k].v[e], w[e], xa.v[e], 0.f);
      } else {
        const Floats<VEC> x1 = load_vec<VEC>(v1 + (b * g2 + (s + k) % g2) * nm + ij);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          r.v[e] = shrink(q1, x[k].v[e], shrink(q2, x1.v[e], w[e], xa.v[e], 0.f),
                          x1.v[e], 0.f);
      }
      store_once<VEC>(out + (b * nslices + s + k) * nm + ij, r);
    }
  }
}

template <int LEAD, int VEC>
cudaError_t split_launch(int batch, int splits, cudaStream_t s, const float* y,
                         const float* v1, const float* v2, const float* vfin,
                         const float* u, float* out, int g1, int g2, int n, int m,
                         int q1, int q2, int qlast, int chunk) {
  const long long positions = static_cast<long long>(n) * (m / VEC);
  const dim3 grid(static_cast<unsigned>((positions + SPLIT_THREADS - 1) / SPLIT_THREADS),
                  batch, splits);
  split_apply_kernel<LEAD, VEC><<<grid, SPLIT_THREADS, 0, s>>>(
      y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, chunk);
  return cudaGetLastError();
}

template <int LEAD>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const float* y,
                   const float* v1, const float* v2, const float* vfin,
                   const float* u, float* out, int g1, int g2, int n, int m,
                   int q1, int q2, int qlast, int rows_per_split) {
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        apply_kernel<LEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  apply_kernel<LEAD><<<grid, dim3(BM, BR), smem, s>>>(
      y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// y, out: (batch, g1, g2, n, m) contiguous float32 (g1 = g2 = 1 for absent
// lead axes; out may alias y); v1/v2: the reduce pass's aggregates (null
// when absent); vfin, u: (batch, m). With qlast == ℓ1, splits must be 1 and
// rows_per_split == n. lead_chunk > 0 takes split_apply_kernel (lead_rank 1
// or 2, no ℓ1 among q1, q2, qlast): `splits` chunks of lead_chunk slices,
// vec 4 (m % 4 == 0, every pointer 16-byte aligned) or 1, rows_per_split
// unused. Returns a cudaError_t.
REPRO_EXPORT int codegen_apply(const float* y, const float* v1, const float* v2,
                               const float* vfin, const float* u, float* out,
                               int batch, int lead_rank, int g1, int g2, int n,
                               int m, int q1, int q2, int qlast,
                               int rows_per_split, int splits, int lead_chunk,
                               int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lead_chunk > 0) {
    if (qlast == NORM_L1 || q1 == NORM_L1 || (lead_rank == 2 && q2 == NORM_L1) ||
        (vec == 4 && m % 4 != 0))
      return cudaErrorInvalidValue;
    const int key = lead_rank * 8 + vec;
    switch (key) {
      case 8 + 1: return split_launch<1, 1>(batch, splits, s, y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, lead_chunk);
      case 8 + 4: return split_launch<1, 4>(batch, splits, s, y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, lead_chunk);
      case 16 + 1: return split_launch<2, 1>(batch, splits, s, y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, lead_chunk);
      case 16 + 4: return split_launch<2, 4>(batch, splits, s, y, v1, v2, vfin, u, out, g1, g2, n, m, q1, q2, qlast, lead_chunk);
      default: return cudaErrorInvalidValue;
    }
  }
  const int smem = qlast == NORM_L1 ? n * BM * static_cast<int>(sizeof(float)) : 0;
  const dim3 grid((m + BM - 1) / BM, batch, splits);
  switch (lead_rank) {
    case 0:
      return launch<0>(grid, smem, s, y, v1, v2, vfin, u, out, g1, g2, n, m,
                       q1, q2, qlast, rows_per_split);
    case 1:
      return launch<1>(grid, smem, s, y, v1, v2, vfin, u, out, g1, g2, n, m,
                       q1, q2, qlast, rows_per_split);
    case 2:
      return launch<2>(grid, smem, s, y, v1, v2, vfin, u, out, g1, g2, n, m,
                       q1, q2, qlast, rows_per_split);
    default:
      return cudaErrorInvalidValue;
  }
}

// y, out: (batch, g1, g2, n, m) contiguous float32 as above (lead_rank 1
// or 2; out may alias y); v1/v2: the reduce pass's aggregates (v2 null for
// lead_rank 1); w: (batch, n, m), the level-(L-1) radii, laid out like the
// last lead aggregate. Returns a cudaError_t.
REPRO_EXPORT int codegen_partial_apply(const float* y, const float* v1,
                                       const float* v2, const float* w,
                                       float* out, int batch, int lead_rank,
                                       int g1, int g2, int n, int m, int q1,
                                       int q2, int rows_per_split, int splits,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + BM - 1) / BM, batch, splits), block(BM, BR);
  if (lead_rank == 1)
    partial_apply_kernel<1><<<grid, block, 0, s>>>(y, v1, v2, w, out, g1, g2, n,
                                                   m, q1, q2, rows_per_split);
  else if (lead_rank == 2)
    partial_apply_kernel<2><<<grid, block, 0, s>>>(y, v1, v2, w, out, g1, g2, n,
                                                   m, q1, q2, rows_per_split);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
