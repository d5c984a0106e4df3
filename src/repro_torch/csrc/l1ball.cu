// l1ball.cu — ℓ1-ball projection of B vectors, one CTA per vector.
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
// Output sign(v) · max(|v| - θ, 0); `out` may alias `v`. Non-finite input
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
//   shared memory beyond (n <= L1_KERNEL_MAX of kernels/codegen/tiling.py),
//   so no sweep reads device memory and the output is written from it;
// - the filter's sum and active count fold in one reduction (the count
//   as a float: exact below 2^24 > L1_KERNEL_MAX).
// φ's max(|v| - θ, 0) is fmaxf: it is read only while mid is finite, and
// there |v| - mid is finite whenever v is (a NaN or inf in v stops or
// poisons the bisection through max|v| first). One item per CTA, so a
// serving bucket's solves run side by side. Radii come from a device
// pointer (the TPU kept them in SMEM) or, for one radius and a null
// pointer, by value.
#include <atomic>

#include "common.cuh"

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
// after that: one barrier per reduction.
template <int P, typename Op>
__device__ __forceinline__ void block_reduce(float (&s)[P],
                                             float (&part)[2][WARPS][SLOTS],
                                             int& buf, Op op) {
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
  buf ^= 1;
}

// a[j] for a uniform runtime j, by selects (no local-memory indexing)
__device__ __forceinline__ float pick(const float (&a)[POINTS], int j) {
  float r = a[0];
#pragma unroll
  for (int q = 1; q < POINTS; ++q) r = q == j ? a[q] : r;
  return r;
}

// K > 0: thread t holds v[t + k·THREADS], k < K, in registers (0 past n);
// K == 0: v sits in dynamic shared memory, thread t owning t, t + THREADS, …
template <int K>
__global__ void __launch_bounds__(THREADS)
l1ball_kernel(const float* v, const float* __restrict__ radii, float radius,
              float* out, int n, int method, int iters) {
  extern __shared__ float staged[];
  __shared__ float part[2][WARPS][SLOTS];
  int buf = 0;
  const int t = threadIdx.x;
  const float* vb = v + static_cast<long long>(blockIdx.x) * n;
  float* ob = out + static_cast<long long>(blockIdx.x) * n;
  const float r = radii != nullptr ? radii[blockIdx.x] : radius;

  float x[K > 0 ? K : 1];
  // f(raw value, whether it is one of v's n) over this thread's values;
  // the register path's padding is 0, which adds nothing to a sum, a max
  // or φ
  auto each = [&](auto f) {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) f(x[k], t + k * THREADS < n);
    } else {
      for (int i = t; i < n; i += THREADS) f(staged[i], true);
    }
  };

  float sm[2] = {0.f, 0.f};  // Σ|v|, max|v|
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = t + k * THREADS < n ? vb[t + k * THREADS] : 0.f;
  } else {
    for (int i = t; i < n; i += THREADS) staged[i] = vb[i];  // read back by t alone
  }
  each([&](float xi, bool) {
    sm[0] += fabsf(xi);
    sm[1] = max_nan(sm[1], fabsf(xi));
  });
  block_reduce(sm, part, buf, SumMax());

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
        block_reduce(phi, part, buf, Sum());
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
        block_reduce(sc, part, buf, Sum());
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
      if (t + k * THREADS < n) ob[t + k * THREADS] = soft_threshold(x[k], theta);
  } else {
    for (int i = t; i < n; i += THREADS) ob[i] = soft_threshold(staged[i], theta);
  }
}

}  // namespace

// v, out: (batch, n) contiguous float32; radii: (batch,), or null for
// `radius` on every item. Returns a cudaError_t.
REPRO_EXPORT int l1ball_project(const float* v, const float* radii,
                                float radius, float* out, int batch, int n,
                                int method, int iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > SMEM_MAX / static_cast<int>(sizeof(float)))
    return cudaErrorInvalidValue;
  if (n <= REG_MAX) {
    l1ball_kernel<REG_ELEMS><<<batch, THREADS, 0, s>>>(v, radii, radius, out,
                                                      n, method, iters);
    return cudaGetLastError();
  }
  // the shared-memory limit, raised once per device to the largest n
  static std::atomic<unsigned long long> raised{0};  // bit d: device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(l1ball_kernel<0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    raised |= bit;
  }
  l1ball_kernel<0><<<batch, THREADS, n * sizeof(float), s>>>(
      v, radii, radius, out, n, method, iters);
  return cudaGetLastError();
}
