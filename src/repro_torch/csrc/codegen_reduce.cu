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
// (kernels/codegen/distributed.py). A NaN propagates through every fold
// (common.cuh), as through reduce_plain's amax and sum.
//
// Geometry (kernels/codegen/tiling.py:reduce_split). Pallas carried the row
// accumulator across a sequential grid axis; Hopper runs CTAs in no order,
// so a CTA owns whole columns instead: CTA (x, z, b) of THREADS threads
// covers `packs` column packs of item b — a pack is VEC = 4 adjacent columns
// read with one 16-byte load (VEC = 1 for a ragged m or an unaligned
// pointer) — and the rows of row chunk z. Thread t owns pack t % packs,
// slice lane (t / packs) % S and row lane t / (packs · S):
//   LEAD 0 — the row lanes fold strided rows, 8 loads in flight per thread;
//   LEAD 1 — each row's g1 lead slices split over the S slice lanes (4 loads
//            in flight per lane), whose partial folds meet in a warp
//            butterfly (the S lanes of a pack share a warp), giving v1;
//   LEAD 2 — the row lanes fold strided rows, each thread its rows' g1 · g2
//            lead elements (4 loads in flight).
// The CTA then folds its row lanes: a butterfly over the lanes inside each
// warp, then the warps through shared memory in warp order. The tiler picks
// `packs` (at least 64 bytes of each row per warp load) so that
// B · ceil(m / (VEC · packs)) CTAs number about one per SM, and the main
// path's requests take one chunk (z = 0 only): the CTA writes vfin itself,
// in one launch. Where the column strips alone leave most SMs idle (few,
// tall columns), the rows split into `splits` chunks too: each CTA writes a
// raw partial row and reduce_finalize folds the chunks in chunk order.
// Every fold has a fixed order and there are no atomics, so sums are
// deterministic; ℓ1/ℓ2 sums run in that order (thread-serial, butterfly,
// warps, chunks), not PyTorch's, which moves them by a few ulps
// (tests/test_torch_reduce_split.py replays the order).
//
// Bound: bytes. Y is read once (the lead folds and the row fold happen in
// registers and one 8 KB shared-memory exchange), the aggregates are written
// once; O(1) operations per element.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;   // tiling.REDUCE_THREADS
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_LOADS = 8;   // LEAD 0: rows in flight per thread
constexpr int LEAD_LOADS = 4;  // LEAD 1/2: lead slices in flight per thread

template <int VEC>
struct alignas(4 * VEC) Floats {
  float v[VEC];
};

// Y is read once: streaming (evict-first) loads
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
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  Floats<VEC> t;
#pragma unroll
  for (int k = 0; k < VEC; ++k) t.v[k] = x[k];
  *reinterpret_cast<Floats<VEC>*>(p) = t;
}

// acc = fold_q(acc, |y|) over LOADS elements loaded first, all in flight.
template <int LOADS, int VEC>
__device__ __forceinline__ void fold_loaded(int q, float (&acc)[VEC],
                                            const Floats<VEC> (&x)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fold(q, acc[k], fabsf(x[u].v[k]));
}

// acc = fold_q(acc, |y|) over the `len` elements at p + l · step, in batches
// of LOADS loads issued before they fold; a ragged tail is one predicated
// batch (0, the identity of every fold, past the end), so it costs one round
// trip to memory, not one per element.
template <int LOADS, int VEC>
__device__ __forceinline__ void fold_strided(int q, float (&acc)[VEC], const float* p,
                                             long long step, int len) {
  int l = 0;
  Floats<VEC> x[LOADS];
  for (; l + LOADS <= len; l += LOADS) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) x[u] = load_once<VEC>(p + (l + u) * step);
    fold_loaded<LOADS, VEC>(q, acc, x);
  }
  if (l < len) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      x[u] = l + u < len ? load_once<VEC>(p + (l + u) * step) : Floats<VEC>{};
    fold_loaded<LOADS, VEC>(q, acc, x);
  }
}

// Combine each lane's acc with the lanes `lo`, 2·lo, … below `hi` apart (a
// xor butterfly inside the warp; every lane ends with the same value, since
// each step adds or maxes the same two operands). Every lane of the warp
// must call it.
template <int VEC>
__device__ __forceinline__ void butterfly(int q, float (&acc)[VEC], int lo, int hi) {
  for (int o = lo; o < hi; o <<= 1)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = combine(q, acc[k], __shfl_xor_sync(FULL, acc[k], o));
}

// at most 64 registers (two CTAs an SM could hold), but LEAD 2's float4 folds
// need more: one CTA per SM runs anyway on the main path
template <int LEAD, int VEC>
__global__ void __launch_bounds__(THREADS, LEAD == 2 ? 1 : 2)
reduce_kernel(const float* __restrict__ y, float* __restrict__ v1,
              float* __restrict__ v2, float* __restrict__ out, int g1, int g2,
              int n, int m, int q1, int q2, int qlast, int packs, int lanes,
              int rows_per_split, int splits, int raw) {
  __shared__ float red[THREADS * 4];  // (THREADS / max(32, packs · S)) x packs · VEC
  const int t = threadIdx.x;
  const int S = LEAD == 1 ? lanes : 1;  // slice lanes
  const int p = t % packs, s = (t / packs) % S, r = t / (packs * S);
  const int R = THREADS / (packs * S);  // row lanes
  const int j0 = (blockIdx.x * packs + p) * VEC;
  const bool valid = j0 < m;  // VEC 4 only when m % 4 == 0: the whole pack
  const long long b = blockIdx.z, nm = static_cast<long long>(n) * m;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const float* yb = y + b * g1 * g2 * nm + j0;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;  // identity of every monoid on |y|

  if (LEAD == 0) {
    if (valid && r0 + r < r1)  // rows r0 + r, + R, ...
      fold_strided<ROW_LOADS, VEC>(qlast, acc, yb + static_cast<long long>(r0 + r) * m,
                                   static_cast<long long>(R) * m, (r1 - 1 - r0 - r) / R + 1);
  } else if (LEAD == 1) {
    // a trip count uniform over the CTA: the slice lanes' butterfly needs
    // every lane of the warp, rows past the chunk included
    for (int base = r0; base < r1; base += R) {
      const int i = base + r;
      const bool ok = valid && i < r1;
      const long long ij = static_cast<long long>(i) * m;
      float a[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = 0.f;
      if (ok && s < g1)  // slices s, s + S, ...
        fold_strided<LEAD_LOADS, VEC>(q1, a, yb + s * nm + ij, S * nm, (g1 - 1 - s) / S + 1);
      butterfly<VEC>(q1, a, packs, packs * S);
      if (ok) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          a[k] = finalize(q1, a[k]);
          acc[k] = fold(qlast, acc[k], a[k]);
        }
        if (s == 0) store<VEC>(v1 + b * nm + ij + j0, a);
      }
    }
  } else {
    if (valid) {
      for (int i = r0 + r; i < r1; i += R) {
        const long long ij = static_cast<long long>(i) * m;
        float c[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) c[k] = 0.f;
        for (int l2 = 0; l2 < g2; ++l2) {
          float a[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) a[k] = 0.f;
          fold_strided<LEAD_LOADS, VEC>(q1, a, yb + l2 * nm + ij,
                                        static_cast<long long>(g2) * nm, g1);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            a[k] = finalize(q1, a[k]);
            c[k] = fold(q2, c[k], a[k]);
          }
          store<VEC>(v1 + (b * g2 + l2) * nm + ij + j0, a);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          c[k] = finalize(q2, c[k]);
          acc[k] = fold(qlast, acc[k], c[k]);
        }
        store<VEC>(v2 + b * nm + ij + j0, c);
      }
    }
  }

  // the CTA's row lanes: those inside a warp by butterfly, then the warps
  // (or, with packs > 32, the row lanes) in order through shared memory
  const int span = max(WARP, packs * S);  // threads per row group
  butterfly<VEC>(qlast, acc, packs * S, WARP);
  if (t % span < packs) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[(t / span) * packs * VEC + p * VEC + k] = acc[k];
  }
  __syncthreads();
  const int groups = THREADS / span, width = packs * VEC;
  const int col0 = blockIdx.x * width;
  for (int c = t; c < width; c += THREADS) {
    if (col0 + c >= m) break;
    float v = red[c];
    for (int g = 1; g < groups; ++g) v = combine(qlast, v, red[g * width + c]);
    if (splits == 1)
      out[b * m + col0 + c] = raw ? v : finalize(qlast, v);
    else
      out[(b * splits + blockIdx.y) * m + col0 + c] = v;
  }
}

// vfin[b, j] from the `splits` raw partial rows of item b, folded in chunk
// order. A CTA covers 32 columns; its 8 thread rows take every 8th chunk,
// then fold through shared memory in thread-row order.
__global__ void __launch_bounds__(256)
reduce_finalize(const float* __restrict__ partial, float* __restrict__ vfin,
                int m, int splits, int qlast, int raw) {
  __shared__ float red[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long b = blockIdx.y;
  float s = 0.f;
  if (j < m)
    for (int z = threadIdx.y; z < splits; z += 8)
      s = combine(qlast, s, partial[(b * splits + z) * m + j]);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
    for (int k = 1; k < 8; ++k) s = combine(qlast, s, red[k][threadIdx.x]);
    vfin[b * m + j] = raw ? s : finalize(qlast, s);
  }
}

template <int LEAD, int VEC>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* y, float* v1,
                   float* v2, float* out, int g1, int g2, int n, int m, int q1,
                   int q2, int qlast, int packs, int lanes, int rows_per_split,
                   int splits, int raw) {
  reduce_kernel<LEAD, VEC><<<grid, THREADS, 0, st>>>(
      y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes,
      rows_per_split, splits, raw);
  return cudaGetLastError();
}

}  // namespace

// y: (batch, g1, g2, n, m) contiguous float32 (g1 = g2 = 1 for absent lead
// axes); v1/v2 may be null when LEAD does not produce them; vfin: (batch, m),
// finalized unless `raw`; partial: (batch, splits, m) scratch, read only when
// splits > 1. The geometry is tiling.reduce_split's: `vec` 4 (m % 4 == 0,
// every pointer 16-byte aligned) or 1, `packs` (a power of two, at most
// THREADS) column packs per CTA, `lanes` slice lanes (LEAD 1; packs · lanes
// <= 32), and n cut into `splits` chunks of rows_per_split rows. Returns a
// cudaError_t.
REPRO_EXPORT int codegen_reduce(const float* y, float* v1, float* v2,
                                float* partial, float* vfin, int batch,
                                int lead_rank, int g1, int g2, int n, int m,
                                int q1, int q2, int qlast, int vec, int packs,
                                int lanes, int rows_per_split, int splits,
                                int raw, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) || m % vec || packs < 1 || packs > THREADS ||
      THREADS % packs || lanes < 1 || (lanes > 1 && (lead_rank != 1 || packs * lanes > WARP)) ||
      (packs & (packs - 1)) || (lanes & (lanes - 1)) || splits < 1)
    return cudaErrorInvalidValue;
  const int pack_count = m / vec;
  const dim3 grid((pack_count + packs - 1) / packs, splits, batch);
  float* out = splits == 1 ? vfin : partial;
  cudaError_t e;
  switch (lead_rank * 8 + vec) {
    case 0 + 1: e = launch<0, 1>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    case 0 + 4: e = launch<0, 4>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    case 8 + 1: e = launch<1, 1>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    case 8 + 4: e = launch<1, 4>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    case 16 + 1: e = launch<2, 1>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    case 16 + 4: e = launch<2, 4>(grid, st, y, v1, v2, out, g1, g2, n, m, q1, q2, qlast, packs, lanes, rows_per_split, splits, raw); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const dim3 fgrid((m + 31) / 32, batch);
  reduce_finalize<<<fgrid, dim3(32, 8), 0, st>>>(partial, vfin, m, splits, qlast, raw);
  return cudaGetLastError();
}
