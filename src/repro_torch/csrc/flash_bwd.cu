// flash_bwd.cu — attention backward (FlashAttention-2), two kernels:
//
//   flash_bwd_dq   dQ = scale · Σ_k dS K, with dS = P ∘ (dO Vᵀ − delta): in
//                  float32 one SIMT CTA per (q tile of 64 rows, query head,
//                  batch item); in bf16 the tensor-core kernel of namespace
//                  tc (128 rows per CTA)
//   flash_bwd_dkv  dV = Σ Pᵀ dO and dK = scale · Σ dSᵀ Q over the kv head's
//                  whole query group (G = Hq / Hkv heads) and every q tile:
//                  in float32 one SIMT CTA per (k tile of 64 keys, kv head,
//                  batch item); in bf16 the tensor-core kernel of namespace
//                  tc
//
// No bf16 input reaches a SIMT kernel: the exports send every bf16 call,
// at every head dim, to namespace tc.
//
// where P = exp(scale · Q Kᵀ − lse) under the mask and delta = rowsum(dO ∘ O)
// (computed by the wrapper, as the JAX package computes it in jnp).
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _bwd_call's
// two pallas_calls, _dq_kernel (:181, call at :302) and _dkv_kernel (:226,
// call at :325). Same layouts: q, o, do, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Sk, D); lse, delta (B, Hq, Sq) float32; queries right-aligned to
// the keys; causal and sliding-window masks; GQA through h / G.
//
// What the TPU kernels' grids did, and what the SIMT kernels do instead:
//   * dQ's sequential k axis becomes a loop inside the CTA over the k tiles
//     that hold a valid key for its rows; the accumulator lives in registers
//     (each thread owns 4 rows × D/16 channels);
//   * dK/dV's sequential fused (group member, q block) axis becomes a loop
//     inside the CTA over the G query heads of its kv head and their q tiles,
//     so the GQA sum is taken in registers: no atomics, no second pass, and
//     the result does not depend on the order blocks run in;
//   * a dead block contributes exactly 0 in the TPU kernels too (its mask is
//     all false and p, dS are selected to 0 under the mask), so the loops
//     skip every tile in which no (query, key) pair is valid, computed from
//     the mask itself; the result does not depend on the TPU's block sizes;
//   * ragged tails are zeroed as they are staged (q/do rows past Sq, k/v
//     rows past Sk), so 0 · padding never turns into NaN; p and dS are
//     selected (not multiplied) to 0 under the mask, so a row no key reaches
//     (lse = -1e30 + log(count)) never overflows into the sums.
//
// Shared-memory staging: the operand whose rows a thread owns is kept
// transposed ([D][68]), so a thread reads its 4 rows with one float4; the
// other operand is kept in natural layout with rows padded to D + 4 floats
// and read by the rows tx + 16j, which puts the 8 lanes of a float4 phase
// on 8 distinct 4-bank groups (no conflicts). P and dS go through shared
// memory for the products that contract over the other axis.
//
// Bound: at granite-3-2b's shape, q (4, 32, 2048, 64), k/v (4, 8, 2048, 64),
// causal, dQ does 3·B·Hq·Sq·Sk·D = 103 GFLOP (S, dP and dS·K, halved by the
// mask) and dK/dV 4·B·Hq·Sq·Sk·D = 137 GFLOP, against 119 MB (dQ) and
// 103 MB (dK/dV) of bf16 inputs and outputs, about twice that in f32: both
// are bound by operations. The SIMT kernels are a simple float32 design
// (FMAs fed from shared memory, no tensor cores) and take float32 only.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::dcol;
using flash::LD;
using flash::THREADS;
using flash::to_f;
constexpr int TQ = flash::TILE;  // q rows per tile
constexpr int TK = flash::TILE;  // keys per tile

template <int D>
constexpr int KS = D + 4;  // row stride of a natural-layout tile

// stage rows [r0, r0 + 64) of a (rows, D) matrix transposed into dst[D][LD],
// zero past n_rows
template <int D, typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int r0,
                                        int n_rows, int tid) {
  for (int e = tid; e < flash::TILE * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = r0 + r;
    dst[d * LD + r] = row < n_rows ? to_f(src[static_cast<long long>(row) * D + d]) : 0.f;
  }
}

// stage rows [r0, r0 + 64) of a (rows, D) matrix in natural layout into
// dst[64][D + 4], zero past n_rows
template <int D, typename T>
__device__ __forceinline__ void stage_n(float* dst, const T* src, int r0,
                                        int n_rows, int tid) {
  for (int e = tid; e < flash::TILE * D / 4; e += THREADS) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    const int row = r0 + r;
    const float4 x = row < n_rows
        ? flash::load4(src + static_cast<long long>(row) * D + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&dst[r * KS<D> + d]) = x;
  }
}

// acc[i][j] += Σ_d at[d][4·ty + i] · bn[tx + 16j][d]: 4 rows of a transposed
// tile against 4 rows of a natural tile, 64 FMAs per 8 float4 loads
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* at,
                                         const float* bn, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[4][4];  // a[dd][i], b[j][dd]
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 t = *reinterpret_cast<const float4*>(&at[(d + dd) * LD + ty * 4]);
      a[dd][0] = t.x; a[dd][1] = t.y; a[dd][2] = t.z; a[dd][3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(&bn[(tx + 16 * j) * KS<D> + d]);
      b[j][0] = t.x; b[j][1] = t.y; b[j][2] = t.z; b[j][3] = t.w;
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[dd][i], b[j][dd], acc[i][j]);
  }
}

// acc[i][jd] += Σ_c wt[c][4·ty + i] · xn[c][dcol(tx, jd)]: a 64-long
// contraction of a transposed weight tile with a natural tile
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16],
                                                const float* wt, const float* xn,
                                                int tx, int ty) {
  constexpr int ND = D / 16;
#pragma unroll 4
  for (int c = 0; c < flash::TILE; ++c) {
    const float4 w = *reinterpret_cast<const float4*>(&wt[c * LD + ty * 4]);
    const float wv[4] = {w.x, w.y, w.z, w.w};
    float xv[ND];
    flash::row_slots<D>(&xn[c * KS<D>], tx, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] = fmaf(wv[i], xv[jd], acc[i][jd]);
  }
}

// ------------------------------------------------------------------- dQ
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int hq, int hkv, int sq, int sk,
                    int causal, int window, float scale) {
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                // [D][LD]   q tile, transposed
  float* doT = qT + D * LD;        // [D][LD]   dO tile, transposed
  float* ks = doT + D * LD;        // [TK][D+4] k tile
  float* vs = ks + TK * KS<D>;     // [TK][D+4] v tile
  float* dsT = vs + TK * KS<D>;    // [TK][LD]  dS, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qbase = (static_cast<long long>(b) * hq + h) * sq * D;
  const long long kvbase =
      (static_cast<long long>(b) * hkv + h / (hq / hkv)) * sk * D;
  const long long rbase = (static_cast<long long>(b) * hq + h) * sq;
  const int shift = sk - sq;  // right alignment of q

  // keys that are valid for some row of the tile: [k_lo, k_hi)
  const int qlo = q0 + shift, qhi = min(q0 + TQ, sq) - 1 + shift;
  int k_lo = 0, k_hi = sk;
  if (causal) k_hi = max(0, min(sk, qhi + 1));
  if (window > 0) k_lo = max(0, qlo - window + 1);

  stage_t<D>(qT, q + qbase, q0, sq, tid);
  stage_t<D>(doT, dout + qbase, q0, sq, tid);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < sq ? lse[rbase + row] : 0.f;
    dl_r[i] = row < sq ? delta[rbase + row] : 0.f;
  }

  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;

  for (int k0 = (k_lo / TK) * TK; k0 < k_hi; k0 += TK) {
    __syncthreads();  // q/dO are staged; the previous tile's ks/dsT are consumed
    stage_n<D>(ks, k + kvbase, k0, sk, tid);
    stage_n<D>(vs, v + kvbase, k0, sk, tid);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qT, ks, tx, ty);
    tile_dot<D>(dp, doT, vs, tx, ty);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = flash::valid(qpos, kpos, sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[i][j] = ok ? p * (dp[i][j] - dl_r[i]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dsT[(tx + 16 * j) * LD + ty * 4]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    tile_accumulate<D>(acc, dsT, ks, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    T* out = dq + qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      out[dcol<D>(tx, jd)] = flash::from_f<T>(acc[i][jd] * scale);
  }
}

// ----------------------------------------------------------------- dK/dV
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                     int sq, int sk, int causal, int window, float scale) {
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;                // [D][LD]   k tile, transposed
  float* vT = kT + D * LD;         // [D][LD]   v tile, transposed
  float* qs = vT + D * LD;         // [TQ][D+4] q tile
  float* dos = qs + TQ * KS<D>;    // [TQ][D+4] dO tile
  float* pS = dos + TQ * KS<D>;    // [TQ][LD]  Pᵀ stored by query row
  float* dsS = pS + TQ * LD;       // [TQ][LD]  dSᵀ stored by query row
  float* lse_s = dsS + TQ * LD;    // [TQ]
  float* dl_s = lse_s + TQ;        // [TQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * TK;  // causal: the longest tiles come first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const long long kvbase = (static_cast<long long>(b) * hkv + hk) * sk * D;
  const int shift = sk - sq;

  // rows that are valid for some key of the tile: [i_lo, i_hi)
  const int khi = min(k0 + TK, sk) - 1;
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? max(0, min(sq, khi + window - shift)) : sq;

  stage_t<D>(kT, k + kvbase, k0, sk, tid);
  stage_t<D>(vT, v + kvbase, k0, sk, tid);

  float dk_acc[4][ND], dv_acc[4][ND];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dk_acc[a][jd] = dv_acc[a][jd] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long qbase = (static_cast<long long>(b) * hq + h) * sq * D;
    const long long rbase = (static_cast<long long>(b) * hq + h) * sq;
    for (int q0 = (i_lo / TQ) * TQ; q0 < i_hi; q0 += TQ) {
      __syncthreads();  // k/v are staged; the previous tile's qs/dos/pS/dsS are consumed
      stage_n<D>(qs, q + qbase, q0, sq, tid);
      stage_n<D>(dos, dout + qbase, q0, sq, tid);
      if (tid < TQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < sq ? lse[rbase + row] : 0.f;
        dl_s[tid] = row < sq ? delta[rbase + row] : 0.f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ for keys 4·ty + a and query rows tx + 16i
      float s[4][4] = {}, dp[4][4] = {};
      tile_dot<D>(s, kT, qs, tx, ty);
      tile_dot<D>(dp, vT, dos, tx, ty);
      float p[4][4], ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tx + 16 * i;
        const int qpos = q0 + r + shift;
        const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int kpos = k0 + ty * 4 + a;
          const bool ok = flash::valid(qpos, kpos, sk, causal, window);
          p[a][i] = ok ? expf(s[a][i] * scale - l) : 0.f;
          ds[a][i] = ok ? p[a][i] * (dp[a][i] - dl) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tx + 16 * i;
        *reinterpret_cast<float4*>(&pS[r * LD + ty * 4]) =
            make_float4(p[0][i], p[1][i], p[2][i], p[3][i]);
        *reinterpret_cast<float4*>(&dsS[r * LD + ty * 4]) =
            make_float4(ds[0][i], ds[1][i], ds[2][i], ds[3][i]);
      }
      __syncthreads();
      tile_accumulate<D>(dv_acc, pS, dos, tx, ty);
      tile_accumulate<D>(dk_acc, dsS, qs, tx, ty);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty * 4 + a;
    if (key >= sk) continue;
    T* dko = dk + kvbase + static_cast<long long>(key) * D;
    T* dvo = dv + kvbase + static_cast<long long>(key) * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      dko[dcol<D>(tx, jd)] = flash::from_f<T>(dk_acc[a][jd] * scale);
      dvo[dcol<D>(tx, jd)] = flash::from_f<T>(dv_acc[a][jd]);
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float)) * (2 * D * LD + 2 * TK * KS<D> + TK * LD);
}

template <int D>
constexpr int dkv_smem() {
  return static_cast<int>(sizeof(float)) *
         (2 * D * LD + 2 * TQ * KS<D> + 2 * TQ * LD + 2 * TQ);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, hq, hkv, sq, sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T>
int launch_dq(const Args& a, void* dq) {
  auto kern = flash_bwd_dq_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + TQ - 1) / TQ, a.hq, a.batch);
  kern<<<grid, THREADS, dq_smem<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(dq), a.hq, a.hkv, a.sq, a.sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  auto kern = flash_bwd_dkv_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sk + TK - 1) / TK, a.hkv, a.batch);
  kern<<<grid, THREADS, dkv_smem<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.hq, a.hkv, a.sq, a.sk,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dq(const Args& a, int d, void* dq) {
  switch (d) {
    case 16: return launch_dq<16, T>(a, dq);
    case 32: return launch_dq<32, T>(a, dq);
    case 64: return launch_dq<64, T>(a, dq);
    case 128: return launch_dq<128, T>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(const Args& a, int d, void* dk, void* dv) {
  switch (d) {
    case 16: return launch_dkv<16, T>(a, dk, dv);
    case 32: return launch_dkv<32, T>(a, dk, dv);
    case 64: return launch_dkv<64, T>(a, dk, dv);
    case 128: return launch_dkv<128, T>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------- dK/dV in bf16: tensor cores
// One CTA per (128 keys, kv head, batch item), k blocks slowest in a linear
// grid so causal's longest CTAs start first: two consumer warpgroups of 64
// keys each (keys are the M of every product) and a producer warp. Its
// first thread loads K and V once, then streams 64-row tiles of Q and dO
// through a ring of BSTAGES (TMA, one full and one empty barrier per stage)
// over the G query heads of the kv head and, for each, the q tiles in
// [i_lo, i_hi); its 32 lanes stage each tile's lse · log2 e and delta in
// shared memory (0 past Sq) and arrive on the same full barrier. Per tile a
// warpgroup, with float32 accumulators,
//   Sᵀ = K Qᵀ, dPᵀ = V dOᵀ          wgmma m64n64k16, operands in shared memory;
//   Pᵀ  = 2^(Sᵀ · scale · log2 e − lse · log2 e) where valid, else 0;
//   dSᵀ = Pᵀ ∘ (dPᵀ − delta) where valid, else 0;
//   dV += Pᵀ dO, dK += dSᵀ Q        wgmma m64n{D}k16, Pᵀ and dSᵀ from
//                                   registers split into two bf16 terms as
//                                   the forward splits P, dO and Q MN-major;
// the GQA sum stays in the accumulators (no atomics, no second pass). p
// and dS are selected, not multiplied, to 0, so a row that no key reaches
// (lse = -1e30 + log n, where 2^(...) overflows) never reaches the sums;
// TMA reads q/do rows past Sq and k/v rows past Sk as 0. A warpgroup skips
// the products of a tile in which none of its keys is valid for any row,
// and tests validity per pair only on tiles that need it. dK · scale and
// dV are rounded to bf16 once.
//
// Bound: at granite-3-2b's shape the four products are 4·B·Hq·Sq·Sk·D / 2
// = 137 GFLOP (206 issued with the two split products) against 84 MB of
// q, k, v, do, lse, delta, dk and dv: bound by operations, 139 µs at
// 989 TFLOP/s.
namespace tc {

using namespace hopper;
constexpr int BKV = 128;  // keys per CTA
constexpr int TQR = 64;   // query rows per streamed tile
constexpr int BSTAGES = 3;
constexpr int THREADS = 2 * WG + 32;  // two consumer warpgroups and a producer warp

template <int D>
struct DkvSmem {
  static constexpr int K = 0;                       // [BKV][D]
  static constexpr int V = BKV * D * 2;
  static constexpr int RING = 2 * BKV * D * 2;      // stage s: Q at RING + 2s·TILE, dO after
  static constexpr int TILE = TQR * D * 2;
  static constexpr int ROWS = RING + BSTAGES * 2 * TILE;  // stage s: lse·log2 e, delta
  static constexpr int BAR = ROWS + BSTAGES * 2 * TQR * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * BSTAGES) + 1024;
};

// Pᵀ and dSᵀ of one tile in place of Sᵀ and dPᵀ (MASK: some pair of the
// tile needs its own test); the thread holds keys key and key + 8 and the
// query columns 8j + 2·quad + e, whose lse · log2 e and delta are in rows
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&st)[TQR / 2], float (&dpt)[TQR / 2],
                                          const float* rows, int qpos0, int key, int sk,
                                          int causal, int window, float scale_log2,
                                          int quad) {
#pragma unroll
  for (int j = 0; j < TQR / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * quad);
    const float2 dl = *reinterpret_cast<const float2*>(rows + TQR + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        const float p = ex2(fmaf(st[x], scale_log2, -(e ? l2.y : l2.x)));
        const float ds = p * (dpt[x] - (e ? dl.y : dl.x));
        if (MASK) {
          const bool ok = flash::valid(qpos0 + 8 * j + 2 * quad + e, key + 8 * i, sk,
                                       causal, window);
          st[x] = ok ? p : 0.f;
          dpt[x] = ok ? ds : 0.f;
        } else {
          st[x] = p;
          dpt[x] = ds;
        }
      }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int batch, int hq, int hkv, int sq,
                    int sk, int causal, int window, float scale) {
  using L = Layout<D>;
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* rows_s = reinterpret_cast<float*>(smem + S::ROWS);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + BSTAGES;

  // one linear grid, k blocks slowest: causal's longest CTAs (k block 0)
  // start first across every head and batch item
  const int hb = batch * hkv;
  const int k0 = (blockIdx.x / hb) * BKV;
  const int hk = blockIdx.x % hkv, b = (blockIdx.x % hb) / hkv;
  const int group = hq / hkv, shift = sk - sq;
  // rows that are valid for some key of the CTA: [i_lo, i_hi)
  const int khi = min(k0 + BKV, sk) - 1;
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? max(0, min(sq, khi + window - shift)) : sq;
  const int qfirst = (i_lo / TQR) * TQR;
  const int nq = i_hi > qfirst ? (i_hi - qfirst + TQR - 1) / TQR : 0;
  const int ntiles = group * nq;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full + s, 32);  // the producer warp's lanes (one of them with the bytes)
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer warp
    const int lane = threadIdx.x % 32;
    if (ntiles > 0) {
      if (lane == 0) {
        const int kvm = b * hkv + hk;
        mbar_expect_tx(full_kv, 2 * BKV * D * 2);
#pragma unroll
        for (int c = 0; c < D / L::BOX; ++c) {
          tma_load(smem + S::K + c * BKV * L::ROW, &tk, full_kv, c * L::BOX, k0, kvm);
          tma_load(smem + S::V + c * BKV * L::ROW, &tv, full_kv, c * L::BOX, k0, kvm);
        }
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % BSTAGES;
        mbar_wait(empty + s, ((t / BSTAGES) & 1) ^ 1);
        const int qm = b * hq + hk * group + t / nq, q0 = qfirst + (t % nq) * TQR;
        // lse · log2 e and delta of the tile's rows, 0 past Sq
        float* rs = rows_s + s * 2 * TQR;
#pragma unroll
        for (int h = 0; h < TQR / 32; ++h) {
          const int row = q0 + h * 32 + lane;
          const long long off = static_cast<long long>(qm) * sq + row;
          rs[h * 32 + lane] = row < sq ? lse[off] * LOG2E : 0.f;
          rs[TQR + h * 32 + lane] = row < sq ? delta[off] : 0.f;
        }
        if (lane == 0) {
          uint8_t* qt = smem + S::RING + 2 * s * S::TILE;
          mbar_expect_tx(full + s, 2 * S::TILE);
#pragma unroll
          for (int c = 0; c < D / L::BOX; ++c) {
            tma_load(qt + c * TQR * L::ROW, &tq, full + s, c * L::BOX, q0, qm);
            tma_load(qt + S::TILE + c * TQR * L::ROW, &tdo, full + s, c * L::BOX, q0, qm);
          }
        } else {
          mbar_arrive(full + s);  // releases this lane's rows
        }
      }
    }
    return;
  }

  // consumers
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r = warp * 16 + lane / 4;  // the thread's keys r and r + 8 of the 64
  const int kw = k0 + wg * 64;         // this warpgroup's first key
  const float scale_log2 = scale * LOG2E;
  const uint32_t ktile = smem_u32(smem + S::K), vtile = smem_u32(smem + S::V);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (ntiles > 0) mbar_wait(full_kv, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BSTAGES;
    const uint32_t ph = (t / BSTAGES) & 1;
    const int q0 = qfirst + (t % nq) * TQR;
    const uint32_t qt = smem_u32(smem + S::RING + 2 * s * S::TILE), dot = qt + S::TILE;
    mbar_wait(full + s, ph);
    // some key of this warpgroup is valid for some row of the tile
    if (kw < sk && q0 < sq && (!causal || kw <= q0 + TQR - 1 + shift) &&
        (window <= 0 || kw + 63 > q0 + shift - window)) {
      float st[TQR / 2], dpt[TQR / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<TQR>(st, L::kmajor(ktile, BKV, wg * 64, kk), L::kmajor(qt, TQR, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<TQR>(dpt, L::kmajor(vtile, BKV, wg * 64, kk), L::kmajor(dot, TQR, 0, kk),
                    kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);
      const bool whole = kw + 64 <= sk && q0 + TQR <= sq &&
                         (!causal || kw + 63 <= q0 + shift) &&
                         (window <= 0 || kw > q0 + TQR - 1 + shift - window);
      const float* rs = rows_s + s * 2 * TQR;
      if (whole)
        dkv_probs<false>(st, dpt, rs, q0 + shift, kw + r, sk, causal, window, scale_log2,
                         quad);
      else
        dkv_probs<true>(st, dpt, rs, q0 + shift, kw + r, sk, causal, window, scale_log2,
                        quad);
      uint32_t phi[TQR / 16][4], plo[TQR / 16][4], dhi[TQR / 16][4], dlo[TQR / 16][4];
#pragma unroll
      for (int kk = 0; kk < TQR / 16; ++kk) {
        a_split(st, kk, phi[kk], plo[kk]);
        a_split(dpt, kk, dhi[kk], dlo[kk]);
      }
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQR / 16; ++kk) {
        mma_rs<D>(dv_acc, phi[kk], L::mnmajor(dot, TQR, kk), 1);
        mma_rs<D>(dv_acc, plo[kk], L::mnmajor(dot, TQR, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < TQR / 16; ++kk) {
        mma_rs<D>(dk_acc, dhi[kk], L::mnmajor(qt, TQR, kk), 1);
        mma_rs<D>(dk_acc, dlo[kk], L::mnmajor(qt, TQR, kk), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(phi);
      fence_regs(plo);
      fence_regs(dhi);
      fence_regs(dlo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  const long long base = (static_cast<long long>(b) * hkv + hk) * sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + r + 8 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long off = (base + key) * D + 8 * j + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int batch, int hq,
               int hkv, int sq, int sk, int causal, int window, float scale,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = tile_map(&tq, q, batch * hq, sq, D, TQR);
  if (!e) e = tile_map(&tdo, dout, batch * hq, sq, D, TQR);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, D, BKV);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, D, BKV);
  if (e) return e;
  constexpr int smem = DkvSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dkv_wgmma<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sk + BKV - 1) / BKV * hkv * batch;
  flash_bwd_dkv_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), batch, hq, hkv, sq, sk, causal, window, scale);
  return cudaGetLastError();
}

// --------------------------------------------- dQ in bf16: tensor cores
// One CTA per (128 query rows, query head, batch item), q blocks slowest
// and the last first in a linear grid (causal's longest CTAs start first)
// and the G query heads of a kv head adjacent (their K/V tiles come from
// L2): two consumer warpgroups of 64 rows each (query rows are the M of
// every product) and a producer warp. Its first thread loads the CTA's Q
// and dO once, then streams 64-key tiles of K and V through a ring of
// STAGES (TMA, one full and one empty barrier per stage) over the keys in
// [k_lo, k_hi) that some row of the CTA reaches. Each consumer thread reads
// lse · log2 e and delta of its own two rows into registers once. Per tile
// a warpgroup, with float32 accumulators,
//   S = Q Kᵀ, dP = dO Vᵀ       wgmma m64n64k16, operands in shared memory;
//   dS = 2^(S · scale · log2 e − lse · log2 e) ∘ (dP − delta) where valid,
//        else 0;
//   dQ += dS K                  wgmma m64n{D}k16, dS from registers split
//                               into two bf16 terms (hopper::split), K
//                               MN-major: the forward's P V with K in V's
//                               place.
// P and dS are selected, not multiplied, to 0, so a row that no key
// reaches (lse = -1e30 + log n, where 2^(...) overflows) never reaches the
// sum; TMA reads q/do rows past Sq and k/v rows past Sk as 0. A warpgroup
// skips the products of a tile in which none of its rows has a valid key,
// and tests validity per pair only on tiles that need it. dQ · scale is
// rounded to bf16 once; a row with no valid key writes 0. No atomics: each
// row's sum runs in one warpgroup in key order, so dQ is deterministic.
//
// Bound: at granite-3-2b's shape the three products are
// 3·B·Hq·Sq·Sk·D / 2 = 103 GFLOP (137 issued with the split product)
// against 119 MB of q, k, v, do, lse, delta and dq: bound by operations,
// 104 µs at 989 TFLOP/s.
constexpr int BQR = 128;  // query rows per dQ CTA
constexpr int BKT = 64;   // keys per streamed tile

template <int D>
struct DqSmem {
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int TILE_Q = BQR * D * 2;
  static constexpr int Q = 0;                       // [BQR][D]
  static constexpr int DO = TILE_Q;                 // [BQR][D]
  static constexpr int RING = 2 * TILE_Q;           // stage s: K at RING + 2s·TILE, V after
  static constexpr int TILE = BKT * D * 2;
  static constexpr int BAR = RING + STAGES * 2 * TILE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// dS of one tile in place of dP (MASK: some pair of the tile needs its own
// test); the thread holds rows qpos0 and qpos0 + 8 (as query positions) and
// the keys key0 + 8j + e, with its rows' lse · log2 e in l2 and delta in dl
template <bool MASK>
__device__ __forceinline__ void dq_scores(const float (&sc)[BKT / 2], float (&dp)[BKT / 2],
                                          const float (&l2)[2], const float (&dl)[2],
                                          int qpos0, int key0, int sk, int causal,
                                          int window, float scale_log2) {
#pragma unroll
  for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        const float ds = ex2(fmaf(sc[x], scale_log2, -l2[i])) * (dp[x] - dl[i]);
        if (MASK)
          dp[x] = flash::valid(qpos0 + 8 * i, key0 + 8 * j + e, sk, causal, window) ? ds : 0.f;
        else
          dp[x] = ds;
      }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                   float scale) {
  using L = Layout<D>;
  using S = DqSmem<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STAGES;

  const int hb = batch * hq, nqb = (sq + BQR - 1) / BQR;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / hb) * BQR;
  const int h = blockIdx.x % hq, b = (blockIdx.x % hb) / hq;
  const int shift = sk - sq;
  // keys that are valid for some row of the CTA: [k_lo, k_hi)
  const int qlo = q0 + shift, qhi = min(q0 + BQR, sq) - 1 + shift;
  const int k_hi = causal ? max(0, min(sk, qhi + 1)) : sk;
  const int k_lo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kfirst = (k_lo / BKT) * BKT;
  const int ntiles = k_hi > kfirst ? (k_hi - kfirst + BKT - 1) / BKT : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer: its first thread issues every load
    if (threadIdx.x == 2 * WG && ntiles > 0) {
      const int qm = b * hq + h, kvm = b * hkv + h / (hq / hkv);
      mbar_expect_tx(full_q, 2 * S::TILE_Q);
#pragma unroll
      for (int c = 0; c < D / L::BOX; ++c) {
        tma_load(smem + S::Q + c * BQR * L::ROW, &tq, full_q, c * L::BOX, q0, qm);
        tma_load(smem + S::DO + c * BQR * L::ROW, &tdo, full_q, c * L::BOX, q0, qm);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, k0 = kfirst + t * BKT;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        uint8_t* kt = smem + S::RING + 2 * s * S::TILE;
        mbar_expect_tx(full + s, 2 * S::TILE);
#pragma unroll
        for (int c = 0; c < D / L::BOX; ++c) {
          tma_load(kt + c * BKT * L::ROW, &tk, full + s, c * L::BOX, k0, kvm);
          tma_load(kt + S::TILE + c * BKT * L::ROW, &tv, full + s, c * L::BOX, k0, kvm);
        }
      }
    }
    return;
  }

  // consumers
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r = warp * 16 + lane / 4;  // the thread's rows r and r + 8 of the 64
  const int rw = q0 + wg * 64;         // this warpgroup's first row
  const float scale_log2 = scale * LOG2E;
  const uint32_t qtile = smem_u32(smem + S::Q), dotile = smem_u32(smem + S::DO);
  const long long mat = static_cast<long long>(b) * hq + h;

  float l2[2], dl[2];  // lse · log2 e and delta of rows rw + r and rw + r + 8, 0 past Sq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + r + 8 * i;
    l2[i] = row < sq ? lse[mat * sq + row] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[mat * sq + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
  if (ntiles > 0) mbar_wait(full_q, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, k0 = kfirst + t * BKT;
    const uint32_t ph = (t / STAGES) & 1;
    const uint32_t kt = smem_u32(smem + S::RING + 2 * s * S::TILE), vt = kt + S::TILE;
    mbar_wait(full + s, ph);
    // some row of this warpgroup has a valid key in the tile
    if (rw < sq && k0 < sk && (!causal || k0 <= rw + 63 + shift) &&
        (window <= 0 || k0 + BKT - 1 > rw + shift - window)) {
      float sc[BKT / 2], dp[BKT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BKT>(sc, L::kmajor(qtile, BQR, wg * 64, kk), L::kmajor(kt, BKT, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BKT>(dp, L::kmajor(dotile, BQR, wg * 64, kk), L::kmajor(vt, BKT, 0, kk),
                    kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);
      const bool whole = k0 + BKT <= sk && rw + 64 <= sq &&
                         (!causal || k0 + BKT - 1 <= rw + shift) &&
                         (window <= 0 || k0 > rw + 63 + shift - window);
      if (whole)
        dq_scores<false>(sc, dp, l2, dl, rw + r + shift, k0 + 2 * quad, sk, causal, window,
                         scale_log2);
      else
        dq_scores<true>(sc, dp, l2, dl, rw + r + shift, k0 + 2 * quad, sk, causal, window,
                        scale_log2);
      uint32_t dhi[BKT / 16][4], dlo[BKT / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) a_split(dp, kk, dhi[kk], dlo[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        mma_rs<D>(acc, dhi[kk], L::mnmajor(kt, BKT, kk), 1);
        mma_rs<D>(acc, dlo[kk], L::mnmajor(kt, BKT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(dhi);
      fence_regs(dlo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + r + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + (mat * sq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c + 2 * quad) = __floats2bfloat162_rn(
          acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch, int hq, int hkv,
              int sq, int sk, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = tile_map(&tq, q, batch * hq, sq, D, BQR);
  if (!e) e = tile_map(&tdo, dout, batch * hq, sq, D, BQR);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, D, BKT);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, D, BKT);
  if (e) return e;
  constexpr int smem = DqSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dq_wgmma<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sq + BQR - 1) / BQR * hq * batch;
  flash_bwd_dq_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), batch, hq, hkv, sq, sk,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, do, dq: (batch, hq, sq, d); k, v, dk, dv: (batch, hkv, sk, d), all
// contiguous and of one type, float32 (bf16 = 0) or bf16 (bf16 = 1); lse,
// delta: (batch, hq, sq) float32. window <= 0 means none; d is 16, 32, 64
// or 128. Each returns a cudaError_t.
REPRO_EXPORT int flash_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int batch, int hq,
                              int hkv, int sq, int sk, int d, int causal,
                              int window, float scale, int bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, hq, hkv, sq, sk, causal,
               window, scale, static_cast<cudaStream_t>(stream)};
  if (!bf16) return dispatch_dq<float>(a, d, dq);
  // bf16: the tensor-core kernel only, for every head dim
  switch (d) {
    case 16: return tc::launch_dq<16>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 32: return tc::launch_dq<32>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 64: return tc::launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 128: return tc::launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    default: return cudaErrorInvalidValue;
  }
}

REPRO_EXPORT int flash_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int batch,
                               int hq, int hkv, int sq, int sk, int d, int causal,
                               int window, float scale, int bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, hq, hkv, sq, sk, causal,
               window, scale, static_cast<cudaStream_t>(stream)};
  if (!bf16) return dispatch_dkv<float>(a, d, dk, dv);
  // bf16: the tensor-core kernel only, for every head dim
  switch (d) {
    case 16: return tc::launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 32: return tc::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 64: return tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    case 128: return tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, causal, window, scale, a.stream);
    default: return cudaErrorInvalidValue;
  }
}
