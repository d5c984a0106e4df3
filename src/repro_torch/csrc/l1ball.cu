// l1ball.cu — ℓ1-ball projection of B vectors, one CTA per vector.
//
// Replaces the TPU kernels of repro/kernels/l1ball.py: project_l1_pallas and
// project_l1_pallas_batched (bodies _l1ball_bisect_kernel and
// _l1ball_filter_kernel). `method` picks the body:
//   0 bisect — lo = 0, hi = max|v|, `iters` (64) block-reduced φ(mid) steps,
//              φ(θ) = Σ max(|v| - θ, 0); θ = 0 inside the ball;
//   1 filter — Michelot fixed point θ ← (Σ_{a>θ} a - r) / #{a > θ} from
//              θ₀ = (Σa - r)/n while the active count changes and stays > 0,
//              at most `iters` (n + 2) sweeps; θ = max(θ, 0), 0 inside.
// Output sign(v) · max(|v| - θ, 0); `out` may alias `v`. Non-finite input
// follows the plain version (kernels/l1ball.py:project_l1_plain): every max
// and clamp keeps NaN (common.cuh's max_nan), so a NaN in v makes θ and the
// whole output NaN, and an +inf makes the bisection's θ +inf, as there.
//
// Bound: the vector is small (the aggregate row of a projection, 2048 floats
// on the main path), so bytes are negligible and the time is the latency of
// `iters` dependent block reductions. The design keeps |v| in shared memory
// (n <= L1_KERNEL_MAX of kernels/codegen/tiling.py) so every sweep reads
// shared memory, and puts one item on each CTA so a serving bucket's solves
// run side by side. Radii come from a device pointer (the TPU kept them in
// SMEM). Block reductions fold warps in a fixed order: deterministic.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {  // keeps NaN, as the plain version's amax does
  __device__ float operator()(float a, float b) const { return max_nan(a, b); }
};

// Block-wide reduction; every thread gets the same value. The leading
// barrier keeps `scratch` intact until every thread read the previous result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < WARPS; ++w) r = op(r, scratch[w]);
  return r;
}

__global__ void __launch_bounds__(THREADS)
l1ball_kernel(const float* v, const float* __restrict__ radii,
              float* out, int n, int method, int iters) {
  extern __shared__ float a[];  // |v| of this item
  __shared__ float fscratch[WARPS];
  __shared__ int iscratch[WARPS];
  const float* vb = v + static_cast<long long>(blockIdx.x) * n;
  float* ob = out + static_cast<long long>(blockIdx.x) * n;
  const float r = radii[blockIdx.x];

  float lsum = 0.f, lmax = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = fabsf(vb[i]);
    a[i] = x;
    lsum += x;
    lmax = max_nan(lmax, x);
  }
  const float s0 = block_reduce(lsum, fscratch, Sum());
  const bool inside = s0 <= r;

  float theta;
  if (method == 0) {
    float lo = 0.f, hi = block_reduce(lmax, fscratch, Max());
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float p = 0.f;
      for (int i = threadIdx.x; i < n; i += THREADS) p += max_nan(a[i] - mid, 0.f);
      const float phi = block_reduce(p, fscratch, Sum());
      if (phi > r) lo = mid; else hi = mid;  // φ too large: θ too small
    }
    theta = inside ? 0.f : 0.5f * (lo + hi);
  } else {
    theta = (s0 - r) / static_cast<float>(n);
    int count = n;
    bool changed = true;
    for (int it = 0; changed && it < iters; ++it) {
      float ps = 0.f;
      int pc = 0;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const float x = a[i];
        if (x > theta) { ps += x; ++pc; }
      }
      const float ssum = block_reduce(ps, fscratch, Sum());
      const int new_count = block_reduce(pc, iscratch, Sum());
      const float new_theta =
          new_count > 0 ? (ssum - r) / static_cast<float>(new_count) : theta;
      changed = new_count != count && new_count > 0;
      theta = new_theta;
      count = new_count;
    }
    theta = inside ? 0.f : max_nan(theta, 0.f);
  }

  for (int i = threadIdx.x; i < n; i += THREADS) ob[i] = soft_threshold(vb[i], theta);
}

}  // namespace

// v, out: (batch, n) contiguous float32; radii: (batch,). Returns a cudaError_t.
REPRO_EXPORT int l1ball_project(const float* v, const float* radii, float* out,
                                int batch, int n, int method, int iters,
                                void* stream) {
  const int smem = n * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      l1ball_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  l1ball_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      v, radii, out, n, method, iters);
  return cudaGetLastError();
}
