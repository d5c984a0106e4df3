// flash_bwd.cu — attention backward (FlashAttention-2) on Hopper's tensor
// cores, two kernels per input type:
//
//   flash_bwd_dq   dQ = scale · Σ_k dS (K − k̄), with dS = P ∘ (dO Vᵀ − delta)
//                  and k̄ each kv head's mean key (a pre-pass, head_means):
//                  one CTA per (q block, query head, batch item), streaming
//                  the keys;
//   flash_bwd_dkv  dV = Σ Pᵀ dO and dK = scale · Σ dSᵀ Q over the kv head's
//                  whole query group (G = Hq / Hkv heads) and every q tile:
//                  one CTA per (k block, kv head, batch item), streaming the
//                  queries.
//
// bf16 runs tc::flash_bwd_dq_wgmma and tc::flash_bwd_dkv_wgmma (bf16
// products, register operands in two bf16 terms); float32 runs
// tc::flash_bwd_dq_tf32 and tc::flash_bwd_dkv_tf32 (three TF32 products per
// product, after a pre-pass that writes each operand's two tf32 terms).
//
// where P = exp(scale · Q Kᵀ − lse) under the mask and delta = rowsum(dO ∘ O)
// (computed by the wrapper, as the JAX package computes it in jnp).
//
// Why K − k̄: each row of dS sums to 0, but only up to the rounding of lse,
// delta and the products, and Σ_k dS K carries that rounding times the
// keys' common part. Where keys share most of their value (a cross-
// attention over encoder states of near-silent audio) it swamps dQ: on
// keys k̄ + 0.01·ε at whisper's cross shape, bf16 dQ came out 4.5e+03 of
// its largest true entry and float32 dQ 62× (chip_smoke.py phase 13).
// Subtracting a common vector changes nothing in exact arithmetic. The
// float32 kernel takes the products against K − k̄, formed in float32
// before the TF32 split (the pre-pass writes Kᵀ that way); the bf16 kernel
// keeps K in its bf16 tiles and subtracts rowsum(dS) · k̄ in float32 from
// its accumulator at the end.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _bwd_call's
// two pallas_calls, _dq_kernel (:181, call at :302) and _dkv_kernel (:226,
// call at :325). Same layouts: q, o, do, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Sk, D); lse, delta (B, Hq, Sq) float32; queries right-aligned to
// the keys; causal and sliding-window masks; GQA through h / G. A head dim
// d (a multiple of 8 up to 128) runs the kernels of the next width up, as
// in flash_fwd.cu (flash::padded_width): the tensor maps read the columns
// past d as 0, which add nothing to S, dP or the pre-pass's planes (written
// at width d, as is k̄), and dq, dk and dv are stored at row stride d with
// the padding's zero columns left out.
//
// What the TPU kernels' grids did, and what these kernels do instead:
//   * dQ's sequential k axis becomes a loop inside the CTA over the k tiles
//     that hold a valid key for its rows, the accumulator in registers;
//   * dK/dV's sequential fused (group member, q block) axis becomes a loop
//     inside the CTA over the G query heads of its kv head and their q tiles,
//     so the GQA sum is taken in the accumulators: no atomics, no second
//     pass, and the result does not depend on the order blocks run in;
//   * a dead block contributes exactly 0 in the TPU kernels too (its mask is
//     all false and p, dS are selected to 0 under the mask), so the loops
//     skip every tile in which no (query, key) pair is valid, computed from
//     the mask itself; the result does not depend on the TPU's block sizes;
//   * TMA reads q/do rows past Sq and k/v rows past Sk as 0, so 0 · padding
//     never turns into NaN; p and dS are selected (not multiplied) to 0
//     under the mask, so a row no key reaches (lse = -1e30 + log(count))
//     never overflows into the sums.
//
// Bound: at granite-3-2b's shape, q (4, 32, 2048, 64), k/v (4, 8, 2048, 64),
// causal, dQ does 3·B·Hq·Sq·Sk·D = 103 GFLOP (S, dP and dS·K, halved by the
// mask) and dK/dV 4·B·Hq·Sq·Sk·D = 137 GFLOP, against 119 MB (dQ) and
// 103 MB (dK/dV) of bf16 inputs and outputs, about twice that in f32: both
// are bound by operations.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------- dK/dV in bf16: tensor cores
// One CTA per (128 keys, kv head, batch item), k blocks slowest in a linear
// grid so causal's longest CTAs start first: two consumer warpgroups of 64
// keys each (keys are the M of every product) and a producer warp. Its
// first thread loads K and V once, then streams 64-row tiles of Q and dO
// through a ring of BSTAGES (TMA, one full and one empty barrier per stage)
// over the q tiles in [i_lo, i_hi), the farthest from the keys first, and
// for each the G query heads of the kv head. Under a causal or windowed
// mask P is largest on the queries nearest the keys, and the chained wgmma
// accumulators keep each tile's contribution only to the precision of the
// running sum: walked nearest first, the large early terms made the many
// small later ones lose their low bits, enough at a long windowed shape
// (1, 32, 6144, 80) to move a few dK/dV entries past phase 1's bar of
// chip_smoke.py; walked farthest first, with the heads interleaved so that
// no head's total sits in the sum while the next head's small terms come,
// the sum grows as its terms do, at the same time (PERF.md § 6). Its 32
// lanes stage each tile's lse · log2 e and delta in
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

// k̄ of dQ: each (batch, kv head)'s mean key over its sk keys, float32,
// into kbar (mats, d), k (mats, sk, d) with d <= D. One block of 1024
// threads per (batch, kv head): a thread sums the VEC columns of a 16-byte
// chunk over every RPP-th key, four chunks in flight (the chunks past d
// sum nothing), then d threads add the RPP partial sums of their column in
// order (the result does not depend on timing).
__device__ __forceinline__ void add_chunk(const uint4& x, float (&sum)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&x);
  sum[0] += f.x;
  sum[1] += f.y;
  sum[2] += f.z;
  sum[3] += f.w;
}
__device__ __forceinline__ void add_chunk(const uint4& x, float (&sum)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    sum[2 * e] += f.x;
    sum[2 * e + 1] += f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(1024)
head_means(const T* __restrict__ k, float* __restrict__ kbar, int sk, int d) {
  constexpr int VEC = 16 / sizeof(T), TPR = D / VEC, RPP = 1024 / TPR;
  __shared__ float part[RPP][D + 1];
  const long long mat = blockIdx.x;
  const int c = threadIdx.x % TPR, r0 = threadIdx.x / TPR, chunks = d / VEC;
  const uint4* rows = reinterpret_cast<const uint4*>(k + mat * sk * d);
  float sum[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = 0.f;
  for (int j0 = r0; j0 < sk; j0 += 4 * RPP) {
    uint4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * RPP;
      x[u] = j < sk && c < chunks ? rows[static_cast<long long>(j) * chunks + c]
                                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) add_chunk(x[u], sum);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[r0][c * VEC + e] = sum[e];
  __syncthreads();
  if (threadIdx.x < d) {
    float total = 0.f;
    for (int i = 0; i < RPP; ++i) total += part[i][threadIdx.x];
    kbar[mat * d + threadIdx.x] = total / sk;
  }
}

template <typename T, int D>
void head_mean(const T* k, float* kbar, int mats, int sk, int d, cudaStream_t stream) {
  head_means<T, D><<<mats, 1024, 0, stream>>>(k, kbar, sk, d);
}

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

// Pᵀ and dSᵀ of one tile of 2·NS query rows in place of Sᵀ and dPᵀ (MASK:
// some pair of the tile needs its own test); the thread holds keys key and
// key + 8 and the query columns 8j + 2·quad + e, whose lse · log2 e and
// delta are in rows
template <bool MASK, int NS>
__device__ __forceinline__ void dkv_probs(float (&st)[NS], float (&dpt)[NS],
                                          const float* rows, int qpos0, int key, int sk,
                                          int causal, int window, float scale_log2,
                                          int quad) {
  constexpr int TQ = 2 * NS;  // query rows of the tile
#pragma unroll
  for (int j = 0; j < TQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * quad);
    const float2 dl = *reinterpret_cast<const float2*>(rows + TQ + 8 * j + 2 * quad);
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
                    int sk, int d, int causal, int window, float scale) {
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
        const int qm = b * hq + hk * group + t % group, q0 = qfirst + (nq - 1 - t / group) * TQR;
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
    const int q0 = qfirst + (nq - 1 - t / group) * TQR;
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
      if (8 * j >= d) continue;  // the padding's zero columns
      const long long off = (base + key) * d + 8 * j + 2 * quad;
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
               int hkv, int sq, int sk, int d, int causal, int window, float scale,
               cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv, tdo;  // boxes of the instantiated width D over the true d
  int e = tile_map(&tq, q, batch * hq, sq, d, TQR, 2, L::BOX);
  if (!e) e = tile_map(&tdo, dout, batch * hq, sq, d, TQR, 2, L::BOX);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, d, BKV, 2, L::BOX);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, d, BKV, 2, L::BOX);
  if (e) return e;
  constexpr int smem = DkvSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dkv_wgmma<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sk + BKV - 1) / BKV * hkv * batch;
  flash_bwd_dkv_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), batch, hq, hkv, sq, sk, d, causal, window, scale);
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
//                               place;
//   rowsum(dS)                  in float32, in registers;
// and at the end dQ −= rowsum(dS) · k̄ (k̄ from head_means, float32).
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

// dS of one tile of 2·NS keys in place of dP (MASK: some pair of the tile
// needs its own test); the thread holds rows qpos0 and qpos0 + 8 (as query
// positions) and the keys key0 + 8j + e, with its rows' lse · log2 e in l2
// and delta in dl
template <bool MASK, int NS>
__device__ __forceinline__ void dq_scores(const float (&sc)[NS], float (&dp)[NS],
                                          const float (&l2)[2], const float (&dl)[2],
                                          int qpos0, int key0, int sk, int causal,
                                          int window, float scale_log2) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
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
                   const float* __restrict__ delta, const float* __restrict__ kbar,
                   __nv_bfloat16* __restrict__ dq, int batch, int hq, int hkv, int sq,
                   int sk, int d, int causal, int window, float scale) {
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
  float acc[D / 2], rs[2] = {0.f, 0.f};  // rs: the rows' sums of dS
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
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // dp[4j + 2i + e] is row i's: four chains of sums
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) part[2 * (j & 1) + e] += dp[4 * j + 2 * i + e];
        rs[i] += (part[0] + part[1]) + (part[2] + part[3]);
      }
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

  // the quad's four threads hold a row's keys between them
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
  }
  const float* kb = kbar + (static_cast<long long>(b) * hkv + h / (hq / hkv)) * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + r + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + (mat * sq + row) * d;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (8 * c >= d) continue;  // the padding's zero columns
      const int col = 8 * c + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
          fmaf(-rs[i], kb[col], acc[4 * c + 2 * i]) * scale,
          fmaf(-rs[i], kb[col + 1], acc[4 * c + 2 * i + 1]) * scale);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, float* kbar, int batch,
              int hq, int hkv, int sq, int sk, int d, int causal, int window, float scale,
              cudaStream_t stream) {
  using L = Layout<D>;
  head_mean<__nv_bfloat16, D>(static_cast<const __nv_bfloat16*>(k), kbar, batch * hkv, sk,
                             d, stream);
  const cudaError_t e0 = cudaGetLastError();
  if (e0) return e0;
  CUtensorMap tq, tk, tv, tdo;  // boxes of the instantiated width D over the true d
  int e = tile_map(&tq, q, batch * hq, sq, d, BQR, 2, L::BOX);
  if (!e) e = tile_map(&tdo, dout, batch * hq, sq, d, BQR, 2, L::BOX);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, d, BKT, 2, L::BOX);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, d, BKT, 2, L::BOX);
  if (e) return e;
  constexpr int smem = DqSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dq_wgmma<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sq + BQR - 1) / BQR * hq * batch;
  flash_bwd_dq_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, kbar, static_cast<__nv_bfloat16*>(dq), batch, hq, hkv, sq,
      sk, d, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------- float32: 3×TF32 on the tensor cores
// Every product is three TF32 products, small·big + big·small + big·big,
// with big = tf32(x) and small = tf32(x - big) (hopper::tf32_split), summed
// in float32, as the float32 forward does: one TF32 product keeps 11 bits
// of each operand, far outside the float32 bar. wgmma reads TF32 operands
// K-major only, so an operand that is contracted over its rows needs a
// transposed copy. A pre-pass (hopper::tf32_planes, tf32_planes_vt) writes
// the two terms of each operand a kernel streams to a scratch buffer the
// wrapper allocates (Tf32BwdWork): dQ's K, V and Kᵀ − k̄, dK/dV's Q, dO, Qᵀ and
// dOᵀ, a transposed one with its rows permuted within each group of 8
// (slot c holds row 2c for c < 4, 2(c - 4) + 1 above), so that P and dS
// enter from the accumulator of S or Sᵀ straight away (hopper::tf32_frag),
// as P enters O += P V in the forward. The streamed transposes must be
// written anyway, and TMA then moves every term with no thread work. dQ's
// Q and dO, which a CTA loads once, arrive raw in their big planes and
// each warpgroup splits its own 64 rows in place (hopper::split_rows):
// both planes share the tile's swizzle, so a 16-byte chunk splits where it
// lies. That saves dQ a 0.14 ms pre-pass of Q and dO at granite's shape
// and took its time from 1.3282 to 1.2713 ms in one call; the same split
// of dK/dV's K and V made that kernel slower (2.3625 against 2.2289 ms
// with K and V from the pre-pass, which costs 0.03 ms), for a reason not
// found, so dK/dV reads them from the pre-pass (scripts/time_ab.py flash,
// a b b a × 3; NVIDIA H100 80GB HBM3, 700 W).
//
// A product with both operands in shared memory at a narrow N reads its A
// (64 rows × 8, 2 KB) for every wgmma, and those reads, not the tensor
// cores, bound it. So each streamed operand's two terms sit box by box as
// one pair of rows (big, then small): one wgmma of twice the width takes
// A big against both (big·big and big·small in its two column halves) and
// a second of the width takes A small against B big; the three sums meet
// in float32 registers, small terms first. Each tile's contribution to a
// dQ, dK or dV accumulator is taken in fresh accumulators and added in
// float32: chained over hundreds of tiles in one wgmma accumulator the
// sums drift (dk at granite's shape 4.5e-4 from the plain version, eight
// times the bar; 2.1e-5 this way).
//
// flash_bwd_dq_tf32: one CTA per (BQ = 64 · NWG query rows, head, batch
// item), q blocks slowest and the last first, the G heads of a kv head
// adjacent (their K/V planes come from L2). A producer warp loads the
// CTA's Q and dO terms once and streams tiles of BK keys (K, V and Kᵀ, two
// terms each) through a ring of STAGES; each consumer warpgroup of 64 rows
// runs S = Q Kᵀ and dP = dO Vᵀ (D/8 wgmma m64n{2·BK}k8 and D/8 m64n{BK}k8
// each, operands in shared memory), dS = 2^(S · scale · log2 e − lse ·
// log2 e) ∘ (dP − delta) where valid (else 0), and dQ += dS (K − k̄) (3 ·
// BK/8 wgmma m64n{D}k8, dS from registers, (K − k̄)ᵀ in shared memory). Four planes
// of Q and dO take 16 · BQ · D bytes, so the key tiles are narrow: 32 keys
// (16 at D = 128, where one warpgroup of rows fits).
//
// flash_bwd_dkv_tf32: one CTA per (BKV = 64 · NWG keys, kv head, batch
// item), k blocks slowest. The producer warp loads K and V (two terms each)
// once and streams tiles of TQ query rows (Q, dO, Qᵀ, dOᵀ, two terms each)
// over the group's heads and the q tiles that reach its keys, its lanes
// staging each tile's lse · log2 e and delta; each consumer warpgroup of 64
// keys runs Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (D/8 wgmma m64n{2·TQ}k8 and D/8
// m64n{TQ}k8 each), Pᵀ and
// dSᵀ where valid, dV += Pᵀ dO and dK += dSᵀ Q (3 · TQ/8 wgmma m64n{D}k8
// each, Pᵀ and dSᵀ from registers, dOᵀ and Qᵀ in shared memory). K and V
// resident take 16 · BKV · D bytes and a tile 32 · TQ · D, so the tiles
// hold 16 query rows (8 at D = 128).
//
// Both write their outputs in float32 once (dQ · scale, dK · scale, dV);
// a row with no valid key writes 0 (dQ), a key with no valid row 0 (dK,
// dV). Bound: the work above (103 and 137 GFLOP at granite's shape) at
// 494.7 TFLOP/s of TF32: 0.208 and 0.278 ms; the split issues three times
// that (0.625 and 0.833 ms). The pre-pass moves 0.13 GB (dQ: reads K and
// V, writes three planes of two terms) and 0.77 GB (dK/dV: reads Q, dO, K
// and V, writes six) at that shape.
template <int D>
struct F32Dq {
  static constexpr int NWG = D == 128 ? 1 : 2;          // consumer warpgroups of 64 rows
  static constexpr int BQ = 64 * NWG;                   // query rows per CTA
  static constexpr int BK = D == 128 ? 16 : 32;         // keys per streamed tile
  static constexpr int STAGES = D <= 32 ? 4 : 2;
  static constexpr int THREADS = NWG * WG + 32;
  static constexpr int QROW = (D < 32 ? D : 32) * 4;    // bytes of a Q/dO/K/V box row
  static constexpr int TILE_Q = BQ * D * 4;             // one plane of Q or dO
  static constexpr int TILE = BK * D * 4;               // one plane of K, V or Kᵀ
  static constexpr int Q = 0;                           // Q big, Q small, dO big, dO small
  static constexpr int RING = 4 * TILE_Q;  // stage s: K pair, V pair, Kᵀ big, Kᵀ small
  static constexpr int BAR = RING + STAGES * 6 * TILE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

template <int D>
struct F32Dkv {
  static constexpr int NWG = D == 128 ? 1 : 2;          // consumer warpgroups of 64 keys
  static constexpr int BKV = 64 * NWG;                  // keys per CTA
  static constexpr int TQ = D == 128 ? 8 : 16;          // query rows per streamed tile
  static constexpr int STAGES = D <= 32 ? 4 : 3;
  static constexpr int THREADS = NWG * WG + 32;
  static constexpr int QROW = (D < 32 ? D : 32) * 4;    // bytes of a K/V/Q/dO box row
  static constexpr int TILE_K = BKV * D * 4;            // one plane of K or V
  static constexpr int TILE = TQ * D * 4;               // one plane of Q, dO, Qᵀ or dOᵀ
  static constexpr int K = 0;                           // K big, K small, V big, V small
  static constexpr int RING = 4 * TILE_K;  // stage s: Q pair, dO pair, Qᵀ b/s, dOᵀ b/s
  static constexpr int ROWS = RING + STAGES * 8 * TILE;  // stage s: lse·log2 e, delta
  static constexpr int BAR = ROWS + STAGES * 2 * TQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(F32Dq<D>::THREADS, 1)
flash_bwd_dq_tf32(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tkt, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq, int batch,
                  int hq, int hkv, int sq, int sk, int d, int causal, int window,
                  float scale) {
  using C = F32Dq<D>;
  using KQ = KMajor<C::QROW>;    // Q, dO, K and V tiles: boxes of [rows][QROW / 4]
  using KT = KMajor<C::BK * 4>;  // Kᵀ tiles: one box of [D][BK keys]
  constexpr int NWG = C::NWG, BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  constexpr int QBOX = C::QROW / 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STAGES;

  const int hb = batch * hq, nqb = (sq + BQ - 1) / BQ;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / hb) * BQ;
  const int h = blockIdx.x % hq, b = (blockIdx.x % hb) / hq;
  const int shift = sk - sq;
  // keys that are valid for some row of the CTA: [k_lo, k_hi)
  const int qlo = q0 + shift, qhi = min(q0 + BQ, sq) - 1 + shift;
  const int k_hi = causal ? max(0, min(sk, qhi + 1)) : sk;
  const int k_lo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kfirst = (k_lo / BK) * BK;
  const int ntiles = k_hi > kfirst ? (k_hi - kfirst + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // producer: its first thread issues every load
    if (threadIdx.x == NWG * WG && ntiles > 0) {
      const int kvmats = batch * hkv;  // a plane's matrices
      const int qm = b * hq + h, kvm = b * hkv + h / (hq / hkv);
      // Q and dO raw, into their big planes (the consumers split them)
      mbar_expect_tx(full_q, 2 * C::TILE_Q);
#pragma unroll
      for (int c = 0; c < D / QBOX; ++c) {
        tma_load(smem + C::Q + c * BQ * C::QROW, &tq, full_q, c * QBOX, q0, qm);
        tma_load(smem + C::Q + 2 * C::TILE_Q + c * BQ * C::QROW, &tdo, full_q, c * QBOX, q0,
                 qm);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, k0 = kfirst + t * BK;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        uint8_t* st = smem + C::RING + s * 6 * C::TILE;
        mbar_expect_tx(full + s, 6 * C::TILE);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
          for (int c = 0; c < D / QBOX; ++c) {  // a pair's box c: big rows, small rows
            const int at = (2 * c + pl) * BK * C::QROW;
            tma_load(st + at, &tk, full + s, c * QBOX, k0, pl * kvmats + kvm);
            tma_load(st + 2 * C::TILE + at, &tv, full + s, c * QBOX, k0, pl * kvmats + kvm);
          }
          tma_load(st + (4 + pl) * C::TILE, &tkt, full + s, k0, 0, pl * kvmats + kvm);
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
  const uint32_t qb = smem_u32(smem + C::Q), qs = qb + C::TILE_Q;
  const uint32_t ob = qb + 2 * C::TILE_Q, os = qb + 3 * C::TILE_Q;
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
  if (ntiles > 0) {  // this warpgroup's rows of Q and dO into their two terms
    mbar_wait(full_q, 0);
    split_rows<D / QBOX, C::QROW>(smem + C::Q, C::TILE_Q, BQ, wg * 64, tid);
    split_rows<D / QBOX, C::QROW>(smem + C::Q + 2 * C::TILE_Q, C::TILE_Q, BQ, wg * 64, tid);
    wg_sync(wg);
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, k0 = kfirst + t * BK;
    const uint32_t ph = (t / STAGES) & 1;
    const uint32_t kp = smem_u32(smem + C::RING + s * 6 * C::TILE), vp = kp + 2 * C::TILE;
    const uint32_t tb = kp + 4 * C::TILE, ts = kp + 5 * C::TILE;
    mbar_wait(full + s, ph);
    // some row of this warpgroup has a valid key in the tile
    if (rw < sq && k0 < sk && (!causal || k0 <= rw + 63 + shift) &&
        (window <= 0 || k0 + BK - 1 > rw + shift - window)) {
      // Q big times the K pair (columns: K big, then K small) in one
      // product, Q small times K big in another; the same for dO and V
      float s2[BK], ss[BK / 2], d2[BK], dsn[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t pair = KQ::kmajor(kp, 2 * BK, 0, kk);
        mma_ss_tf32<2 * BK>(s2, KQ::kmajor(qb, BQ, wg * 64, kk), pair, kk > 0);
        mma_ss_tf32<BK>(ss, KQ::kmajor(qs, BQ, wg * 64, kk), pair, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t pair = KQ::kmajor(vp, 2 * BK, 0, kk);
        mma_ss_tf32<2 * BK>(d2, KQ::kmajor(ob, BQ, wg * 64, kk), pair, kk > 0);
        mma_ss_tf32<BK>(dsn, KQ::kmajor(os, BQ, wg * 64, kk), pair, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s2);
      fence_regs(ss);
      fence_regs(d2);
      fence_regs(dsn);
      float sc[BK / 2], dp[BK / 2];  // small terms first, then big · big
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = s2[i] + (s2[BK / 2 + i] + ss[i]);
        dp[i] = d2[i] + (d2[BK / 2 + i] + dsn[i]);
      }
      const bool whole = k0 + BK <= sk && rw + 64 <= sq &&
                         (!causal || k0 + BK - 1 <= rw + shift) &&
                         (window <= 0 || k0 > rw + 63 + shift - window);
      if (whole)
        dq_scores<false>(sc, dp, l2, dl, rw + r + shift, k0 + 2 * quad, sk, causal, window,
                         scale_log2);
      else
        dq_scores<true>(sc, dp, l2, dl, rw + r + shift, k0 + 2 * quad, sk, causal, window,
                        scale_log2);
      uint32_t db[BK / 8][4], dsm[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) tf32_frag(dp, kk, db[kk], dsm[kk]);
      float part[D / 2];  // this tile's dS K, added to acc in float32
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t bb = KT::kmajor(tb, D, 0, kk);
        mma_rs_tf32<D>(part, dsm[kk], bb, kk > 0);
        mma_rs_tf32<D>(part, db[kk], KT::kmajor(ts, D, 0, kk), 1);
        mma_rs_tf32<D>(part, db[kk], bb, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      fence_regs(db);
      fence_regs(dsm);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] += part[c];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + r + 8 * i;
    if (row >= sq) continue;
    float* out = dq + (mat * sq + row) * d;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      if (8 * c < d)  // columns past d are the padding's zeros
        *reinterpret_cast<float2*>(out + 8 * c + 2 * quad) =
            make_float2(acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::THREADS, 1)
flash_bwd_dkv_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tqt,
                   const __grid_constant__ CUtensorMap tdot,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int batch, int hq, int hkv, int sq, int sk,
                   int d, int causal, int window, float scale) {
  using C = F32Dkv<D>;
  using KQ = KMajor<C::QROW>;    // K, V, Q and dO tiles: boxes of [rows][QROW / 4]
  using QT = KMajor<C::TQ * 4>;  // Qᵀ and dOᵀ tiles: one box of [D][TQ rows]
  constexpr int NWG = C::NWG, BKV = C::BKV, TQ = C::TQ, STAGES = C::STAGES;
  constexpr int QBOX = C::QROW / 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* rows_s = reinterpret_cast<float*>(smem + C::ROWS);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + STAGES;

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
  const int qfirst = (i_lo / TQ) * TQ;
  const int nq = i_hi > qfirst ? (i_hi - qfirst + TQ - 1) / TQ : 0;
  const int ntiles = group * nq;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);       // the producer warp's lanes (one of them with the bytes)
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // producer warp
    const int lane = threadIdx.x % 32;
    const int qmats = batch * hq, kvmats = batch * hkv;  // a plane's matrices
    if (ntiles > 0) {
      if (lane == 0) {
        const int kvm = b * hkv + hk;
        mbar_expect_tx(full_kv, 4 * C::TILE_K);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int c = 0; c < D / QBOX; ++c) {
            tma_load(smem + C::K + pl * C::TILE_K + c * BKV * C::QROW, &tk, full_kv,
                     c * QBOX, k0, pl * kvmats + kvm);
            tma_load(smem + C::K + (2 + pl) * C::TILE_K + c * BKV * C::QROW, &tv, full_kv,
                     c * QBOX, k0, pl * kvmats + kvm);
          }
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        const int qm = b * hq + hk * group + t / nq, q0 = qfirst + (t % nq) * TQ;
        // lse · log2 e and delta of the tile's rows, 0 past Sq
        float* rs = rows_s + s * 2 * TQ;
        for (int i = lane; i < TQ; i += 32) {
          const int row = q0 + i;
          const long long off = static_cast<long long>(qm) * sq + row;
          rs[i] = row < sq ? lse[off] * LOG2E : 0.f;
          rs[TQ + i] = row < sq ? delta[off] : 0.f;
        }
        if (lane == 0) {
          uint8_t* st = smem + C::RING + s * 8 * C::TILE;
          mbar_expect_tx(full + s, 8 * C::TILE);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
            for (int c = 0; c < D / QBOX; ++c) {  // a pair's box c: big rows, small rows
              const int at = (2 * c + pl) * TQ * C::QROW;
              tma_load(st + at, &tq, full + s, c * QBOX, q0, pl * qmats + qm);
              tma_load(st + 2 * C::TILE + at, &tdo, full + s, c * QBOX, q0, pl * qmats + qm);
            }
            tma_load(st + (4 + pl) * C::TILE, &tqt, full + s, q0, 0, pl * qmats + qm);
            tma_load(st + (6 + pl) * C::TILE, &tdot, full + s, q0, 0, pl * qmats + qm);
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
  const uint32_t kb = smem_u32(smem + C::K), ks = kb + C::TILE_K;
  const uint32_t vb = kb + 2 * C::TILE_K, vs = kb + 3 * C::TILE_K;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (ntiles > 0) mbar_wait(full_kv, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int q0 = qfirst + (t % nq) * TQ;
    const uint32_t qp = smem_u32(smem + C::RING + s * 8 * C::TILE), op = qp + 2 * C::TILE;
    const uint32_t qtb = qp + 4 * C::TILE, qts = qp + 5 * C::TILE;
    const uint32_t otb = qp + 6 * C::TILE, ots = qp + 7 * C::TILE;
    mbar_wait(full + s, ph);
    // some key of this warpgroup is valid for some row of the tile
    if (kw < sk && q0 < sq && (!causal || kw <= q0 + TQ - 1 + shift) &&
        (window <= 0 || kw + 63 > q0 + shift - window)) {
      // K big times the Q pair (columns: Q big, then Q small) in one
      // product, K small times Q big in another; the same for V and dO
      float s2[TQ], ss[TQ / 2], d2[TQ], dsn[TQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t pair = KQ::kmajor(qp, 2 * TQ, 0, kk);
        mma_ss_tf32<2 * TQ>(s2, KQ::kmajor(kb, BKV, wg * 64, kk), pair, kk > 0);
        mma_ss_tf32<TQ>(ss, KQ::kmajor(ks, BKV, wg * 64, kk), pair, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t pair = KQ::kmajor(op, 2 * TQ, 0, kk);
        mma_ss_tf32<2 * TQ>(d2, KQ::kmajor(vb, BKV, wg * 64, kk), pair, kk > 0);
        mma_ss_tf32<TQ>(dsn, KQ::kmajor(vs, BKV, wg * 64, kk), pair, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s2);
      fence_regs(ss);
      fence_regs(d2);
      fence_regs(dsn);
      float st[TQ / 2], dpt[TQ / 2];  // small terms first, then big · big
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) {
        st[i] = s2[i] + (s2[TQ / 2 + i] + ss[i]);
        dpt[i] = d2[i] + (d2[TQ / 2 + i] + dsn[i]);
      }
      const bool whole = kw + 64 <= sk && q0 + TQ <= sq &&
                         (!causal || kw + 63 <= q0 + shift) &&
                         (window <= 0 || kw > q0 + TQ - 1 + shift - window);
      const float* rs = rows_s + s * 2 * TQ;
      if (whole)
        dkv_probs<false>(st, dpt, rs, q0 + shift, kw + r, sk, causal, window, scale_log2,
                         quad);
      else
        dkv_probs<true>(st, dpt, rs, q0 + shift, kw + r, sk, causal, window, scale_log2,
                        quad);
      uint32_t pb[TQ / 8][4], ps[TQ / 8][4], db[TQ / 8][4], dsm[TQ / 8][4];
#pragma unroll
      for (int kk = 0; kk < TQ / 8; ++kk) {
        tf32_frag(st, kk, pb[kk], ps[kk]);
        tf32_frag(dpt, kk, db[kk], dsm[kk]);
      }
      float part[D / 2];  // this tile's Pᵀ dO, then its dSᵀ Q, added in float32
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 8; ++kk) {
        const uint64_t bb = QT::kmajor(otb, D, 0, kk);
        mma_rs_tf32<D>(part, ps[kk], bb, kk > 0);
        mma_rs_tf32<D>(part, pb[kk], QT::kmajor(ots, D, 0, kk), 1);
        mma_rs_tf32<D>(part, pb[kk], bb, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dv_acc[c] += part[c];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 8; ++kk) {
        const uint64_t bb = QT::kmajor(qtb, D, 0, kk);
        mma_rs_tf32<D>(part, dsm[kk], bb, kk > 0);
        mma_rs_tf32<D>(part, db[kk], QT::kmajor(qts, D, 0, kk), 1);
        mma_rs_tf32<D>(part, db[kk], bb, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      fence_regs(db);
      fence_regs(dsm);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dk_acc[c] += part[c];
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
      if (8 * j >= d) continue;  // the padding's zero columns
      const long long off = (base + key) * d + 8 * j + 2 * quad;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// The float32 backward's scratch, in floats: the two tf32 terms of each
// operand that comes from the pre-pass, as it is and transposed (rows
// padded to a multiple of 32): dQ's K, V and (K − k̄)ᵀ, or dK/dV's Q, dO,
// Qᵀ, dOᵀ, K and V, in this order (launch_dq_tf32 and launch_dkv_tf32
// carve it; the exports check the caller's buffer against it). dQ splits
// its Q and dO in shared memory, so they take no scratch. dQ's scratch
// starts with k̄ (kbar floats), in both types.
struct Tf32BwdWork {
  long long nq, nk, nqt, nkt, kbar;
  int sqp, skp;
  Tf32BwdWork(int batch, int hq, int hkv, int sq, int sk, int d)
      : nq(static_cast<long long>(batch) * hq * sq * d),
        nk(static_cast<long long>(batch) * hkv * sk * d),
        nqt(static_cast<long long>(batch) * hq * d * ((sq + 31) / 32 * 32)),
        nkt(static_cast<long long>(batch) * hkv * d * ((sk + 31) / 32 * 32)),
        kbar(static_cast<long long>(batch) * hkv * d),
        sqp((sq + 31) / 32 * 32), skp((sk + 31) / 32 * 32) {}
  long long floats(bool dkv) const { return dkv ? 4 * (nq + nqt + nk) : 4 * nk + 2 * nkt; }
  // the whole scratch an export checks: dQ's k̄ and, in float32, the
  // planes; dK/dV's planes in float32, none in bf16
  long long needed(bool dkv, bool bf16) const {
    const long long planes = bf16 ? 0 : floats(dkv);
    return dkv ? planes : kbar + planes;
  }
};

template <int D>
int launch_dq_tf32(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq, float* work, int batch,
                   int hq, int hkv, int sq, int sk, int d, int causal, int window,
                   float scale, cudaStream_t stream) {
  using C = F32Dq<D>;
  constexpr int QBOX = C::QROW / 4;
  const Tf32BwdWork w(batch, hq, hkv, sq, sk, d);
  float* kbar = work;           // k̄: (batch · hkv, d)
  float* kp = kbar + w.kbar;    // K big, K small: (2 · batch · hkv, sk, d)
  float* vp = kp + 2 * w.nk;    // V big, V small
  float* ktp = vp + 2 * w.nk;   // (K − k̄)ᵀ big, small: (2 · batch · hkv, d, skp)
  head_mean<float, D>(k, kbar, batch * hkv, sk, d, stream);
  planes_t(k, ktp, batch * hkv, sk, w.skp, d, stream, kp, kbar);
  planes(v, vp, w.nk, nullptr, stream);
  const cudaError_t e0 = cudaGetLastError();
  if (e0) return e0;
  // Q and dO raw; boxes of the instantiated width D over the true d (the
  // transposed Kᵀ: D rows over its d)
  CUtensorMap tq, tdo, tk, tv, tkt;
  int e = tile_map(&tq, q, batch * hq, sq, d, C::BQ, 4, QBOX);
  if (!e) e = tile_map(&tdo, dout, batch * hq, sq, d, C::BQ, 4, QBOX);
  if (!e) e = tile_map(&tk, kp, 2 * batch * hkv, sk, d, C::BK, 4, QBOX);
  if (!e) e = tile_map(&tv, vp, 2 * batch * hkv, sk, d, C::BK, 4, QBOX);
  if (!e) e = tile_map(&tkt, ktp, 2 * batch * hkv, d, w.skp, D, 4, C::BK);
  if (e) return e;
  constexpr int smem = C::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dq_tf32<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sq + C::BQ - 1) / C::BQ * hq * batch;
  flash_bwd_dq_tf32<D><<<grid, C::THREADS, smem, stream>>>(
      tq, tdo, tk, tv, tkt, lse, delta, dq, batch, hq, hkv, sq, sk, d, causal, window,
      scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dk, float* dv, float* work,
                    int batch, int hq, int hkv, int sq, int sk, int d, int causal,
                    int window, float scale, cudaStream_t stream) {
  using C = F32Dkv<D>;
  constexpr int QBOX = C::QROW / 4;
  const Tf32BwdWork w(batch, hq, hkv, sq, sk, d);
  float* qp = work;               // Q big, Q small: (2 · batch · hq, sq, d)
  float* dop = qp + 2 * w.nq;     // dO big, dO small
  float* qtp = dop + 2 * w.nq;    // Qᵀ big, Qᵀ small: (2 · batch · hq, d, sqp)
  float* dotp = qtp + 2 * w.nqt;  // dOᵀ big, dOᵀ small
  float* kp = dotp + 2 * w.nqt;   // K big, K small: (2 · batch · hkv, sk, d)
  float* vp = kp + 2 * w.nk;      // V big, V small
  planes_t(q, qtp, batch * hq, sq, w.sqp, d, stream, qp);
  planes_t(dout, dotp, batch * hq, sq, w.sqp, d, stream, dop);
  planes(k, kp, w.nk, nullptr, stream);
  planes(v, vp, w.nk, nullptr, stream);
  const cudaError_t e0 = cudaGetLastError();
  if (e0) return e0;
  // boxes of the instantiated width D over the true d (the transposed
  // planes: D rows over their d)
  CUtensorMap tq, tdo, tqt, tdot, tk, tv;
  int e = tile_map(&tq, qp, 2 * batch * hq, sq, d, C::TQ, 4, QBOX);
  if (!e) e = tile_map(&tdo, dop, 2 * batch * hq, sq, d, C::TQ, 4, QBOX);
  if (!e) e = tile_map(&tqt, qtp, 2 * batch * hq, d, w.sqp, D, 4, C::TQ);
  if (!e) e = tile_map(&tdot, dotp, 2 * batch * hq, d, w.sqp, D, 4, C::TQ);
  if (!e) e = tile_map(&tk, kp, 2 * batch * hkv, sk, d, C::BKV, 4, QBOX);
  if (!e) e = tile_map(&tv, vp, 2 * batch * hkv, sk, d, C::BKV, 4, QBOX);
  if (e) return e;
  constexpr int smem = C::BYTES;
  int sms = 0;
  e = prepare<flash_bwd_dkv_tf32<D>>(smem, &sms);
  if (e) return e;
  const int grid = (sk + C::BKV - 1) / C::BKV * hkv * batch;
  flash_bwd_dkv_tf32<D><<<grid, C::THREADS, smem, stream>>>(
      tq, tdo, tqt, tdot, tk, tv, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, do, dq: (batch, hq, sq, d); k, v, dk, dv: (batch, hkv, sk, d), all
// contiguous and of one type, float32 (bf16 = 0) or bf16 (bf16 = 1); lse,
// delta: (batch, hq, sq) float32. work: float32 scratch of work_floats
// floats, at least tc::Tf32BwdWork::needed() of the kernel (dQ: k̄, then in
// float32 the pre-pass's planes; dK/dV: the planes in float32, null and 0
// in bf16). window <= 0 means none; d is a multiple of 8 from 8 to 128
// (flash::padded_width: the kernels of the next width up run on it).
// Both types run on the tensor cores. Each returns a cudaError_t.
REPRO_EXPORT int flash_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, void* work,
                              long long work_floats, int batch, int hq,
                              int hkv, int sq, int sk, int d, int causal,
                              int window, float scale, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (work == nullptr ||
      work_floats < tc::Tf32BwdWork(batch, hq, hkv, sq, sk, d).needed(false, bf16))
    return cudaErrorInvalidValue;
  float* kb = static_cast<float*>(work);
  if (bf16) {
    switch (flash::padded_width(d)) {
      case 16: return tc::launch_dq<16>(q, k, v, dout, lse, delta, dq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 32: return tc::launch_dq<32>(q, k, v, dout, lse, delta, dq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 64: return tc::launch_dq<64>(q, k, v, dout, lse, delta, dq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 128: return tc::launch_dq<128>(q, k, v, dout, lse, delta, dq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
  float* fdq = static_cast<float*>(dq);
  switch (flash::padded_width(d)) {
    case 16: return tc::launch_dq_tf32<16>(fq, fk, fv, fo, lse, delta, fdq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 32: return tc::launch_dq_tf32<32>(fq, fk, fv, fo, lse, delta, fdq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 64: return tc::launch_dq_tf32<64>(fq, fk, fv, fo, lse, delta, fdq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 128: return tc::launch_dq_tf32<128>(fq, fk, fv, fo, lse, delta, fdq, kb, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

REPRO_EXPORT int flash_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, void* work,
                               long long work_floats, int batch, int hq, int hkv,
                               int sq, int sk, int d, int causal, int window,
                               float scale, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (flash::padded_width(d)) {
      case 16: return tc::launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 32: return tc::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 64: return tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      case 128: return tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (work == nullptr ||
      work_floats < tc::Tf32BwdWork(batch, hq, hkv, sq, sk, d).needed(true, false))
    return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
  float *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv),
        *fw = static_cast<float*>(work);
  switch (flash::padded_width(d)) {
    case 16: return tc::launch_dkv_tf32<16>(fq, fk, fv, fo, lse, delta, fdk, fdv, fw, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 32: return tc::launch_dkv_tf32<32>(fq, fk, fv, fo, lse, delta, fdk, fdv, fw, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 64: return tc::launch_dkv_tf32<64>(fq, fk, fv, fo, lse, delta, fdk, fdv, fw, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    case 128: return tc::launch_dkv_tf32<128>(fq, fk, fv, fo, lse, delta, fdk, fdv, fw, batch, hq, hkv, sq, sk, d, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
