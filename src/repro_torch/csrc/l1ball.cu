// l1ball.cu — ℓ1-ball projection of B vectors: one CTA per vector up to
// 51,200 values, one thread block cluster per vector beyond, up to JAX's
// L1_KERNEL_MAX of 524,288; float32 or bf16.
//
// Replaces the TPU kernels of repro/kernels/l1ball.py: project_l1_pallas and
// project_l1_pallas_batched (bodies _l1ball_bisect_kernel and
// _l1ball_filter_kernel). `method` picks the body:
//   0 bisect — lo = 0, hi = max|v|, at most `iters` (64) steps
//              mid = (lo + hi) / 2, lo = mid if φ(mid) > r else hi = mid,
//              φ(θ) = Σ max(|v| - θ, 0); θ = (lo + hi) / 2, 0 inside the ball;
//   1 filter — Michelot fixed point θ ← (Σ_{a>θ} a - r) / #{a > θ} from
//              θ₀ = (Σa - r)/n while the active count changes and stays > 0,
//              at most `iters` (n + 2) sweeps; θ = max(θ, 0), 0 inside.
// Output sign(v) · max(|v| - θ, 0); `out` may alias `v`. bf16 v is read
// into float32 (|v| exactly), the radius is rounded to bf16 first (as JAX's
// jnp.asarray(radius, v.dtype)), the solve runs in float32 and the output
// is rounded to bf16 once at the store. Non-finite input
// follows the plain version (kernels/l1ball.py:project_l1_plain): a NaN in v
// makes max|v|, θ and the whole output NaN, and an +inf makes the
// bisection's θ +inf, as there.
//
// Bound: the vector is small (the aggregate row of a projection, 2048 floats
// on the main path), so bytes and operations are negligible and the time is
// the latency of dependent block reductions. The design cuts their number
// and their cost:
// - the bisection stops at its float fixed point: once mid equals lo or hi,
//   a further step either leaves (lo, hi) as they are or collapses them
//   onto mid, so θ = (lo + hi) / 2 = mid either way (for mid below 2^127,
//   where mid + mid is finite) and the 64-step θ is the one of the step
//   where it stops (a NaN mid equals nothing and runs on, as before; +inf
//   gives mid = hi at once);
// - one reduction evaluates φ at the 2^LEVELS - 1 midpoints of the next
//   LEVELS steps (every midpoint computed as (lo + hi) / 2 from the bounds
//   the steps before it would leave), then walks them: the same θ sequence
//   as step by step, for half of the reductions (on an H100, LEVELS = 2
//   solved W1's aggregate in 6.9 µs against 10.0 at 3 and 15.6 at 4:
//   every point costs a shuffle tree; PERF.md § 6);
// - a reduction takes one barrier: a butterfly inside each warp, the warps'
//   partials in a double-buffered shared array, a butterfly over them. A
//   butterfly of a commutative + or max leaves the same bits in every lane,
//   so every thread reads the same φ and every branch on it is uniform,
//   and each φ(θ) is summed in one fixed order whichever slot holds θ;
// - v stays in registers (REG_ELEMS per thread) up to REG_MAX values, in
//   shared memory beyond (n <= L1_ONE_CTA_MAX of kernels/codegen/tiling.py),
//   so no sweep reads device memory and the output is written from it;
// - the filter's sum and active count fold in one reduction (the count
//   as a float: exact below 2^24 > L1_KERNEL_MAX).
// φ's max(|v| - θ, 0) is fmaxf: it is read only while mid is finite, and
// there |v| - mid is finite whenever v is (a NaN or inf in v stops or
// poisons the bisection through max|v| first). One item per CTA, so a
// serving bucket's solves run side by side. Radii come from a device
// pointer (the TPU kept them in SMEM) or, for one radius and a null
// pointer, by value.
//
// Longer vectors (up to L1_KERNEL_MAX = 524,288 values, 2 MiB of float32)
// do not fit one SM's shared memory, so l1ball_cluster_project gives each
// item a thread block cluster of CLUSTER CTAs (a power of two, 2 to 16:
// cluster_ctas), each holding a contiguous chunk of ceil(n / CLUSTER)
// values in its shared memory as float32, and runs the same solve: every
// reduction folds the CTA as above, then each CTA publishes its total in
// a double-buffered slot, a cluster barrier, and every warp of every CTA
// reads the CLUSTER totals through distributed shared memory, lane l the
// one of rank l % CLUSTER, and folds them by butterfly: the same operands
// in the same tree everywhere, so every thread of the cluster reads the
// same φ bits and every branch stays uniform across the cluster. One
// cluster barrier per reduction (the slots alternate, as `part` does). A
// cluster of 16 is non-portable (opted in per kernel); clusters of one
// item are scheduled on one GPC.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REG_ELEMS = 8;                   // values per thread in registers
constexpr int REG_MAX = THREADS * REG_ELEMS;   // 2048
constexpr int SMEM_MAX = 200 * 1024;           // tiling.SMEM_BUDGET_BYTES
constexpr int LEVELS = 2;                      // bisection steps per reduction
constexpr int POINTS = (1 << LEVELS) - 1;      // φ evaluations per reduction
constexpr int SLOTS = POINTS + 1;              // a warp's partials, padded
constexpr unsigned FULL = 0xffffffffu;
constexpr int L1_MAX = 512 * 1024;             // tiling.L1_KERNEL_MAX (JAX's)
constexpr int CLUSTER_MAX = 16;                // non-portable above 8
constexpr int CHUNK_TARGET = 16 * 1024;        // values a cluster CTA aims to hold

// storage types: float32, or bf16 read into float32 and rounded at the store
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Sum {
  __device__ float operator()(int, float a, float b) const { return a + b; }
};
struct SumMax {  // slot 0 a sum, slot 1 a max that keeps NaN
  __device__ float operator()(int p, float a, float b) const {
    return p == 0 ? a + b : max_nan(a, b);
  }
};

// Fold s[0..P) across the CTA; every thread gets the same bits. `part`
// alternates between two buffers, so the reads of one reduction end before
// anyone passes the next one's barrier, and a buffer is written again only
// after that: one barrier per reduction. In a cluster (CLUSTER > 1) the CTA
// totals then fold across it through `slot` (this CTA's [2][SLOTS] in
// shared memory, alternating with `part`): rank r's total is read by lane
// r (mod CLUSTER) of every warp and folded by butterfly, in one order for
// every thread of the cluster.
template <int CLUSTER, int P, typename Op>
__device__ __forceinline__ void reduce(float (&s)[P], float (&part)[2][WARPS][SLOTS],
                                       float (&slot)[2][SLOTS], int& buf, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = op(p, s[p], __shfl_xor_sync(FULL, s[p], o));
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) part[buf][threadIdx.x >> 5][p] = s[p];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = part[buf][lane % WARPS][p];
#pragma unroll
  for (int o = 1; o < WARPS; o <<= 1)
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = op(p, s[p], __shfl_xor_sync(FULL, s[p], o));
  if constexpr (CLUSTER > 1) {
    const cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) slot[buf][p] = s[p];
    }
    cluster.sync();  // release this CTA's slot, acquire every other's
    const float* theirs = cluster.map_shared_rank(&slot[buf][0], lane % CLUSTER);
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = theirs[p];
#pragma unroll
    for (int o = 1; o < CLUSTER; o <<= 1)
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = op(p, s[p], __shfl_xor_sync(FULL, s[p], o));
  }
  buf ^= 1;
}

// a[j] for a uniform runtime j, by selects (no local-memory indexing)
__device__ __forceinline__ float pick(const float (&a)[POINTS], int j) {
  float r = a[0];
#pragma unroll
  for (int q = 1; q < POINTS; ++q) r = q == j ? a[q] : r;
  return r;
}

// One item per CTA (CLUSTER == 1) or per cluster of CLUSTER CTAs, the
// cluster's rank r holding values [r · chunk, (r + 1) · chunk) of its n.
// K > 0: thread t holds v[t + k·THREADS], k < K, in registers (0 past n);
// K == 0: the CTA's values sit in dynamic shared memory, thread t owning
// t, t + THREADS, …
template <typename T, int K, int CLUSTER>
__global__ void __launch_bounds__(THREADS)
l1ball_kernel(const T* v, const float* __restrict__ radii, float radius, T* out, int n,
              int chunk, int method, int iters) {
  extern __shared__ float staged[];
  __shared__ float part[2][WARPS][SLOTS];
  __shared__ float slot[2][SLOTS];
  int buf = 0;
  const int t = threadIdx.x;
  const int item = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  // this CTA's values: [first, first + len) of the item's n
  const int first = min(n, rank * chunk), len = min(n, first + chunk) - first;
  const T* vb = v + static_cast<long long>(item) * n + first;
  T* ob = out + static_cast<long long>(item) * n + first;
  // the radius in v's type (JAX: jnp.asarray(radius, v.dtype))
  const float r = widen(narrow<T>(radii != nullptr ? radii[item] : radius));

  float x[K > 0 ? K : 1];
  // f(raw value, whether it is one of v's n) over this thread's values;
  // the register path's padding is 0, which adds nothing to a sum, a max
  // or φ
  auto each = [&](auto f) {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) f(x[k], t + k * THREADS < len);
    } else {
      for (int i = t; i < len; i += THREADS) f(staged[i], true);
    }
  };

  float sm[2] = {0.f, 0.f};  // Σ|v|, max|v|
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = t + k * THREADS < len ? widen(vb[t + k * THREADS]) : 0.f;
  } else {
    for (int i = t; i < len; i += THREADS) staged[i] = widen(vb[i]);  // read back by t alone
  }
  each([&](float xi, bool) {
    sm[0] += fabsf(xi);
    sm[1] = max_nan(sm[1], fabsf(xi));
  });
  reduce<CLUSTER>(sm, part, slot, buf, SumMax());

  float theta = 0.f;  // inside the ball
  if (!(sm[0] <= r)) {
    if (method == 0) {
      float lo = 0.f, hi = sm[1];
      int it = 0;
      bool stop = false;
      while (!stop && it < iters) {
        // the midpoints of the next LEVELS steps, heap order: node j's
        // children 2j + 1 (φ <= r: hi = mid) and 2j + 2 (φ > r: lo = mid)
        float nlo[POINTS], nhi[POINTS], mid[POINTS];
        nlo[0] = lo;
        nhi[0] = hi;
#pragma unroll
        for (int j = 0; j < POINTS; ++j) {
          mid[j] = 0.5f * (nlo[j] + nhi[j]);
          if (2 * j + 2 < POINTS) {
            nlo[2 * j + 1] = nlo[j];
            nhi[2 * j + 1] = mid[j];
            nlo[2 * j + 2] = mid[j];
            nhi[2 * j + 2] = nhi[j];
          }
        }
        float phi[POINTS];
#pragma unroll
        for (int j = 0; j < POINTS; ++j) phi[j] = 0.f;
        each([&](float xi, bool) {
          const float a = fabsf(xi);
#pragma unroll
          for (int j = 0; j < POINTS; ++j) phi[j] += fmaxf(a - mid[j], 0.f);
        });
        reduce<CLUSTER>(phi, part, slot, buf, Sum());
        int j = 0;
        for (int level = 0; level < LEVELS && it < iters; ++level, ++it) {
          const float m = pick(mid, j);
          if (m == lo || m == hi) {  // the float fixed point: θ = m
            stop = true;
            break;
          }
          if (pick(phi, j) > r) {  // φ too large: θ too small
            lo = m;
            j = 2 * j + 2;
          } else {
            hi = m;
            j = 2 * j + 1;
          }
        }
      }
      theta = 0.5f * (lo + hi);
    } else {
      theta = (sm[0] - r) / static_cast<float>(n);
      int count = n;
      bool changed = true;
      for (int it = 0; changed && it < iters; ++it) {
        float sc[2] = {0.f, 0.f};  // Σ_{a>θ} a, #{a > θ}
        each([&](float xi, bool valid) {
          const float a = fabsf(xi);
          if (valid && a > theta) {
            sc[0] += a;
            sc[1] += 1.f;
          }
        });
        reduce<CLUSTER>(sc, part, slot, buf, Sum());
        const int new_count = static_cast<int>(sc[1]);
        const float new_theta =
            new_count > 0 ? (sc[0] - r) / static_cast<float>(new_count) : theta;
        changed = new_count != count && new_count > 0;
        theta = new_theta;
        count = new_count;
      }
      theta = max_nan(theta, 0.f);
    }
  }

  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t + k * THREADS < len) ob[t + k * THREADS] = narrow<T>(soft_threshold(x[k], theta));
  } else {
    for (int i = t; i < len; i += THREADS) ob[i] = narrow<T>(soft_threshold(staged[i], theta));
  }
  // no CTA leaves while another may still read its slots
  if constexpr (CLUSTER > 1) cg::this_cluster().sync();
}

// the dynamic shared-memory limit of kernel `fn`, raised once per device
// (and, for a cluster above the portable 8, the opt-in to its size)
template <typename F>
cudaError_t raise_once(F fn, std::atomic<unsigned long long>& raised, bool nonportable) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (raised.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess && nonportable)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  raised |= bit;
  return cudaSuccess;
}

template <typename T>
cudaError_t project(const void* v, const float* radii, float radius, void* out, int batch,
                    int n, int method, int iters, cudaStream_t s) {
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (n < 1 || n > SMEM_MAX / static_cast<int>(sizeof(float)))
    return cudaErrorInvalidValue;
  if (n <= REG_MAX) {
    l1ball_kernel<T, REG_ELEMS, 1><<<batch, THREADS, 0, s>>>(vt, radii, radius, ot, n, n,
                                                             method, iters);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> raised{0};  // bit d: device d
  const cudaError_t e = raise_once(l1ball_kernel<T, 0, 1>, raised, false);
  if (e != cudaSuccess) return e;
  l1ball_kernel<T, 0, 1><<<batch, THREADS, n * sizeof(float), s>>>(
      vt, radii, radius, ot, n, n, method, iters);
  return cudaGetLastError();
}

// CTAs of one item's cluster: the smallest power of two from 2 whose
// chunks hold at most CHUNK_TARGET values, at most CLUSTER_MAX
int cluster_ctas(int n) {
  int c = 2;
  while (c < CLUSTER_MAX && (n + c - 1) / c > CHUNK_TARGET) c *= 2;
  return c;
}

template <typename T, int CLUSTER>
cudaError_t cluster_launch(const T* v, const float* radii, float radius, T* out, int batch,
                           int n, int method, int iters, cudaStream_t s) {
  static std::atomic<unsigned long long> raised{0};  // bit d: device d
  const cudaError_t e =
      raise_once(l1ball_kernel<T, 0, CLUSTER>, raised, CLUSTER > 8);
  if (e != cudaSuccess) return e;
  const int chunk = (n + CLUSTER - 1) / CLUSTER;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = chunk * sizeof(float);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, l1ball_kernel<T, 0, CLUSTER>, v, radii, radius, out, n,
                            chunk, method, iters);
}

template <typename T>
cudaError_t project_cluster(const void* v, const float* radii, float radius, void* out,
                            int batch, int n, int method, int iters, cudaStream_t s) {
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (n < 1 || n > L1_MAX) return cudaErrorInvalidValue;
  switch (cluster_ctas(n)) {
    case 2: return cluster_launch<T, 2>(vt, radii, radius, ot, batch, n, method, iters, s);
    case 4: return cluster_launch<T, 4>(vt, radii, radius, ot, batch, n, method, iters, s);
    case 8: return cluster_launch<T, 8>(vt, radii, radius, ot, batch, n, method, iters, s);
    default: return cluster_launch<T, 16>(vt, radii, radius, ot, batch, n, method, iters, s);
  }
}

}  // namespace

// v, out: (batch, n) contiguous, float32 (dtype 0) or bf16 (dtype 1),
// 1 <= n <= 51,200; radii: (batch,) float32, or null for `radius` on every
// item (each rounded to v's type). One CTA per item. Returns a cudaError_t.
REPRO_EXPORT int l1ball_project(const void* v, const float* radii, float radius, void* out,
                                int batch, int n, int method, int iters, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? project<__nv_bfloat16>(v, radii, radius, out, batch, n, method, iters, s)
               : project<float>(v, radii, radius, out, batch, n, method, iters, s);
}

// The same for 1 <= n <= 524,288 (L1_KERNEL_MAX): one thread block cluster
// of cluster_ctas(n) CTAs per item. Returns a cudaError_t.
REPRO_EXPORT int l1ball_cluster_project(const void* v, const float* radii, float radius,
                                        void* out, int batch, int n, int method,
                                        int iters, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? project_cluster<__nv_bfloat16>(v, radii, radius, out, batch, n, method,
                                                iters, s)
               : project_cluster<float>(v, radii, radius, out, batch, n, method, iters, s);
}
