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
// axis. Hopper runs CTAs in no order; colmax gives each CTA whole columns
// instead, so one launch writes v: CTA x of COLMAX_THREADS threads owns
// `packs` packs of VEC neighbouring columns (one 16-byte load per row each)
// and every row of them. Thread t owns pack t % packs and row lane
// t / packs; its row lane walks rows t / packs, + R, … (R = COLMAX_THREADS
// / packs) with COLMAX_LOADS loads in flight, then the row lanes fold — by
// butterfly inside each warp, then the warps through shared memory — and
// the CTA writes its columns of v in Y's type. The wrapper
// (kernels/bilevel_l1inf.py:colmax_shape) doubles `packs` from 64 bytes of
// each row until the CTAs fit in one wave of the card (two per SM), so no
// second wave runs part-full and no partial maxima go through memory: one
// launch, and the output is the call's one allocation. Max is exact and
// order-free, NaN included (max_nan), so the result is deterministic.
// clip streams Y as one run of packs (golden.cuh: stream_clip), one CTA
// per 8 KB tile, its radii gathered from u by column.
#include "golden.cuh"

namespace {

using namespace golden;

constexpr int COLMAX_THREADS = 512;  // bilevel_l1inf.COLMAX_THREADS
constexpr int COLMAX_LOADS = 8;      // rows in flight per thread (4 for
                                     // bf16's 8-wide packs: within 64 registers)
constexpr int WARP = 32;

template <typename S, int VEC>
__global__ void __launch_bounds__(COLMAX_THREADS, 2)
colmax_kernel(const S* __restrict__ y, S* __restrict__ out, int n, int m,
              int packs) {
  // (COLMAX_THREADS / max(32, packs)) row groups x packs · VEC columns
  __shared__ float red[COLMAX_THREADS * VEC];
  const int t = threadIdx.x;
  const int p = t % packs, r = t / packs, R = COLMAX_THREADS / packs;
  const int j0 = (blockIdx.x * packs + p) * VEC;
  constexpr int LOADS = VEC == 8 ? COLMAX_LOADS / 2 : COLMAX_LOADS;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;  // identity of the max on |y|
  if (j0 < m) {  // VEC > 1 only when m % VEC == 0: the whole pack is valid
    const S* yj = y + j0;
    // batches of LOADS loads issued before they fold; a ragged tail
    // is one predicated batch (0, the max's identity on |y|, past row n), so
    // it costs one round trip to memory, not one per row
    Pack<S, VEC> x[LOADS];
    int i = r;
    for (; i + (LOADS - 1) * R < n; i += LOADS * R) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        x[u] = load<S, VEC>(yj + static_cast<long long>(i + u * R) * m);
      fold_abs_max<S, VEC, LOADS>(acc, x);
    }
    if (i < n) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        x[u] = i + u * R < n ? load<S, VEC>(yj + static_cast<long long>(i + u * R) * m)
                             : Pack<S, VEC>{};
      fold_abs_max<S, VEC, LOADS>(acc, x);
    }
  }
  // the row lanes inside a warp (lanes packs, 2·packs, … apart), then the
  // warps (or, with packs > 32, the row lanes) through shared memory
  for (int o = packs; o < WARP; o <<= 1)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], o));
  const int span = max(WARP, packs), width = packs * VEC;
  if (t % span < packs) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[(t / span) * width + p * VEC + k] = acc[k];
  }
  __syncthreads();
  const int col0 = blockIdx.x * width;
  for (int c = t; c < width && col0 + c < m; c += COLMAX_THREADS) {
    float a = red[c];
    for (int g = 1; g < COLMAX_THREADS / span; ++g) a = max_nan(a, red[g * width + c]);
    out[col0 + c] = narrow<S>(a);
  }
}

// clip's radius: u[j] of the element's column
template <typename S, int VEC>
struct ColumnRadius {
  const S* __restrict__ u;
  int m;
  __device__ Pack<S, VEC> pack(long long, int j) const { return column_radius<S, VEC>(u, j, m); }
  __device__ float one(long long, int j) const { return widen(u[j]); }
};

template <typename S, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS, stream_min_ctas<S>())
clip_kernel(const S* __restrict__ y, const S* __restrict__ u,
            S* __restrict__ x, int m, long long plane) {
  stream_clip<S, VEC>(y, x, ColumnRadius<S, VEC>{u, m}, 1, m, plane, 1);
}

template <typename S, int VEC>
cudaError_t colmax_launch(const void* y, void* out, int n, int m, int packs,
                          cudaStream_t s) {
  colmax_kernel<S, VEC><<<ceil_div(m / VEC, packs), COLMAX_THREADS, 0, s>>>(
      static_cast<const S*>(y), static_cast<S*>(out), n, m, packs);
  return cudaGetLastError();
}

template <typename S, int VEC>
cudaError_t clip_launch(const void* y, const void* u, void* x, int n, int m,
                        cudaStream_t s) {
  const long long plane = static_cast<long long>(n) * m;
  const long long ctas = stream_ctas(plane, VEC, 1);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  clip_kernel<S, VEC><<<static_cast<unsigned>(ctas), STREAM_THREADS, 0, s>>>(
      static_cast<const S*>(y), static_cast<const S*>(u), static_cast<S*>(x),
      m, plane);
  return cudaGetLastError();
}

}  // namespace

// v (m,) = column max of |y| (n, m), in y's type. `vec` is 1 or
// 16 / sizeof(element); `packs` (a power of two dividing COLMAX_THREADS)
// column packs per CTA.
REPRO_EXPORT int golden_colmax(const void* y, void* out, int dtype, int vec,
                               int n, int m, int packs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packs < 1 || packs > COLMAX_THREADS || COLMAX_THREADS % packs)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return vec > 1 ? colmax_launch<float, 4>(y, out, n, m, packs, s)
                   : colmax_launch<float, 1>(y, out, n, m, packs, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? colmax_launch<bf16_bits, 8>(y, out, n, m, packs, s)
                   : colmax_launch<bf16_bits, 1>(y, out, n, m, packs, s);
  return cudaErrorInvalidValue;
}

// x (n, m) = clip(y, ±u) with u (m,) in y's type. `vec` is 1 or
// 16 / sizeof(element) (every pointer 16-byte aligned).
REPRO_EXPORT int golden_clip(const void* y, const void* u, void* x, int dtype,
                             int vec, int n, int m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return vec > 1 ? clip_launch<float, 4>(y, u, x, n, m, s)
                   : clip_launch<float, 1>(y, u, x, n, m, s);
  if (dtype == DTYPE_BF16)
    return vec > 1 ? clip_launch<bf16_bits, 8>(y, u, x, n, m, s)
                   : clip_launch<bf16_bits, 1>(y, u, x, n, m, s);
  return cudaErrorInvalidValue;
}
