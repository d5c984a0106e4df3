// flash_fwd.cu — attention forward by online softmax: a SIMT float32
// kernel (below) and, for bf16 (the trainer's compute type), a tensor-core
// kernel (namespace tc). No bf16 input reaches the SIMT kernel.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py: _fwd_call
// (pallas_call at :145, body _flash_kernel at :75). It computes the same
// (o, lse): q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D) and
// lse (B, Hq, Sq), with queries right-aligned to the keys (absolute position
// i + Sk - Sq), causal and sliding-window masks, and GQA through the kv head
// h / (Hq / Hkv).
//
// What the TPU kernel's grid did, and what the float32 kernel does instead
// (one CTA per (q tile of 64 rows, query head, batch item)):
//   * the sequential ("arbitrary") k grid axis becomes a loop inside the
//     CTA; the running max m, denominator l and the accumulator live in
//     registers (each thread owns 4 rows × D/16 channels);
//   * K and V tiles of 64 keys are staged through shared memory; q and K are
//     kept transposed there so the score loop reads 4 rows and 4 keys per
//     float4 load (16 FMAs per two shared-memory loads), and the tile of
//     probabilities goes through shared memory to the P·V product;
//   * dead blocks are skipped by bounding the loop, not by a predicate per
//     block. The bounds are the TPU kernel's own liveness rule evaluated on
//     its (block_q, block_k) = (min(128, Sq), min(128, Sk)) blocks, passed in
//     by the wrapper: causal stops after the last live k block, a window
//     starts at the first live one.
//
// Numerics follow the TPU kernel exactly, including its corner cases: masked
// logits are -1e30 (not -inf), so a row that is masked across a whole live
// block gets p = exp(0) = 1 there until a valid key's correction exp(m - m')
// wipes it; a row that no key reaches (causal with Sq > Sk) keeps those
// terms, averaging V over the slots of the live blocks (the zeroed ragged
// tail of the last k block included). Keys past the live blocks are not
// slots at all (p = 0). l == 0 becomes 1; lse = m + log(l). The float32
// kernel uses expf/logf, never the fast intrinsics, and no tensor cores, so
// no TF32; o is rounded to the input type at the store, lse stays float32.
//
// Bound: at the harvest's shape (4, 32, 2048, 64) f32 causal the work is
// 2·B·Hq·Sq·Sk·D ≈ 68.7 GFLOP against 134 MB of q, k, v and o, so the
// kernel is bound by float32 operations (67 TFLOP/s outside the tensor
// cores), not bytes. The score and P·V loops are the whole cost; this
// simple SIMT kernel keeps them on FMAs fed from shared memory.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::dcol;
using flash::FULL;
using flash::LD;              // row stride of the transposed tiles (keeps float4 alignment)
using flash::THREADS;         // 16 × 16: ty owns rows 4ty..4ty+3, tx keys 4tx..4tx+3
using flash::to_f;
constexpr int BQ = flash::TILE;  // query rows per CTA (kernels/flash_attention.py: TILE_Q)
constexpr int BK = flash::TILE;  // keys per shared-memory tile
constexpr float NEG = -1e30f;    // the TPU kernel's _NEG_INF

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int causal, int window, float scale, int block_q, int block_k) {
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [D][LD]  q tile, transposed
  float* kT = qT + D * LD;     // [D][LD]  k tile, transposed
  float* vs = kT + D * LD;     // [BK][D]  v tile
  float* pT = vs + BK * D;     // [BK][LD] probabilities, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qbase = (static_cast<long long>(b) * hq + h) * sq * D;
  const long long kvbase =
      (static_cast<long long>(b) * hkv + h / (hq / hkv)) * sk * D;
  const int shift = sk - sq;  // right alignment of q

  // key slots [slot_lo, slot_hi): the live k blocks of this CTA's q block
  // (the wrapper guarantees a CTA's 64 rows lie in one q block)
  const int qs = (q0 / block_q) * block_q + shift;
  const int nkb = (sk + block_k - 1) / block_k;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {  // live iff kb·block_k <= qs + block_q - 1
    const int last = qs + block_q - 1;
    kb_hi = last < 0 ? 0 : min(nkb, last / block_k + 1);
  }
  if (window > 0) {  // live iff kb·block_k + block_k - 1 > qs - window
    const int t = qs - window - block_k + 1;
    const int fl = t >= 0 ? t / block_k : -((-t + block_k - 1) / block_k);
    kb_lo = max(0, fl + 1);
  }
  const int slot_lo = kb_lo * block_k, slot_hi = kb_hi * block_k;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    qT[d * LD + r] = row < sq ? to_f(q[qbase + static_cast<long long>(row) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }

  for (int k0 = slot_lo; k0 < slot_hi; k0 += BK) {
    __syncthreads();  // q is staged; the previous tile's kT/vs/pT are consumed
    // the ragged tail is zeroed before any product, so padding never turns
    // into NaN through 0 · garbage
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < sk) {
        const long long off = kvbase + static_cast<long long>(kp) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      kT[d * LD + r] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kT[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row; the 16 lanes that
    // share a row are one half-warp, reduced with xor shuffles below 16
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + shift;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = -INFINITY;  // past the live blocks: not a slot
        if (kpos < slot_hi) {
          bool ok = kpos < sk && qpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? s[i][j] * scale : NEG;
        }
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
      const float mn = fmaxf(m[i], mc);  // >= NEG: column k0 is always a slot
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
      l[i] = corr * l[i] + ps;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] *= corr;
      m[i] = mn;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&pT[c * LD + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float vv[ND];
      if constexpr (ND >= 4) {
#pragma unroll
        for (int g = 0; g < ND / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(&vs[c * D + g * 64 + tx * 4]);
          vv[4 * g] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) vv[jd] = vs[c * D + dcol<D>(tx, jd)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      orow[dcol<D>(tx, jd)] = flash::from_f<T>(acc[i][jd] / denom);
    if (tx == 0)
      lse[(static_cast<long long>(b) * hq + h) * sq + row] = m[i] + logf(denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int hq, int hkv, int sq, int sk, int causal, int window,
           float scale, int block_q, int block_k, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * (2 * D * LD + BK * D + BK * LD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hkv, sq, sk, causal, window, scale, block_q,
      block_k);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int batch, int hq, int hkv, int sq, int sk, int d, int causal,
             int window, float scale, int block_q, int block_k, cudaStream_t st) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 32: return launch<32, T>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 64: return launch<64, T>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 128: return launch<128, T>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- bf16: the tensor cores
// A persistent grid (one CTA per SM) walks work items of BQ = 192 query
// rows of one head and batch item, longest causal items first. A CTA has
// three consumer warpgroups of 64 rows and a producer warp whose first
// thread issues every TMA load: each item's Q into one of two buffers (so
// the next item's Q lands while this one ends), then K and V tiles of BK
// keys through a ring of STAGES that runs on across items, each stage with
// full barriers for K and V and an empty barrier the consumer warps arrive
// on. GQA reads kv head h / (Hq / Hkv) through the tensor map's matrix
// coordinate; a box past Sk reads 0 within its own head. A wgmma issue
// holds its warp until the tensor cores take it, so a warpgroup's own
// softmax does not overlap its products: the overlap comes from the three
// warpgroups, which run free of each other (416 threads leave 128
// registers a thread, enough at BK = 64 with no spill at D <= 64). Per tile
// a warpgroup
//   S = Q Kᵀ          wgmma m64n{BK}k16, both operands in shared memory;
//   online softmax    on the accumulators: a row's values live in one quad,
//                     so its max is two xor shuffles; the sum stays per
//                     thread until the epilogue; the row's reference max
//                     moves (and O is rescaled) only when a tile's max
//                     passes it by more than 8;
//   O += P V          wgmma m64n{D}k16 with P from registers, split into
//                     two bf16 terms (hopper::split): two products into one
//                     accumulator hold P to 2^-16, so O is the plain
//                     version's up to summation order and one bf16 rounding
//                     at the store (one bf16 P would put about
//                     2^-8 · |v| / sqrt(n) on outputs near 0, far outside
//                     that bar).
// Logits are scaled by scale · log2(e) (inside the exponent's FMA on a tile
// with no masked pair when scale > 0) and exponentiated by ex2; the sentinels stay as they
// are: a masked slot is -1e30 (2^0 = 1 while the whole row is masked), a
// key past the live blocks -inf, and lse = m · ln 2 + log(l), or
// -1e30 + log(l) while m is the sentinel. Liveness is evaluated per
// warpgroup (its 64 rows lie in one q block when block_q is a multiple of
// 64 or all of Sq); the CTA loads the union of the ranges and a
// warpgroup skips the tiles outside its own. An item with no live tile
// still writes its rows (o = 0, lse = -1e30).
//
// Bound: at granite-3-2b's (4, 32, 2048, 64)/(4, 8, 2048, 64) causal the
// two products are 2·B·Hq·Sq·Sk·D / 2 ≈ 68.7 GFLOP of bf16 tensor-core work
// (P V twice over with the split: 103 GFLOP issued) against 50 MB of q, k,
// v, o and lse: bound by operations, 69 µs at 989 TFLOP/s.
namespace tc {

using namespace hopper;
constexpr int NWG = 3;          // consumer warpgroups of 64 rows
constexpr int BQ = 64 * NWG;    // query rows per work item
constexpr int THREADS = NWG * WG + 32;  // and a producer warp
constexpr float NEG = -1e30f;   // the TPU kernel's _NEG_INF
constexpr float LN2 = 0.6931471805599453f;

constexpr int BK = 64;          // keys per tile

template <int D>
struct FwdSmem {                 // byte offsets from a 1024-aligned base
  // the K/V ring runs on across a CTA's items, so its depth also covers
  // the next item's first tiles while this one ends
  static constexpr int STAGES = D == 128 ? 3 : 8;
  static constexpr int TILE_Q = BQ * D * 2;
  static constexpr int Q = 0;                       // two Q buffers, items alternate
  static constexpr int KV = 2 * TILE_Q;             // stage s: K at KV + 2s·TILE, V after
  static constexpr int TILE = BK * D * 2;
  static constexpr int BAR = KV + STAGES * 2 * TILE;
  static constexpr int BYTES = BAR + 8 * (4 + 3 * STAGES) + 1024;  // + alignment
};

// key slots [lo, hi) of the TPU blocks that are live for the q block
// holding row0 (empty when row0 is past the rows)
struct Slots { int lo, hi; };
__device__ __forceinline__ Slots live_slots(int row0, int sq, int sk, int causal,
                                            int window, int block_q, int block_k) {
  if (row0 >= sq) return {0, 0};
  const int qs = (row0 / block_q) * block_q + sk - sq;
  const int nkb = (sk + block_k - 1) / block_k;
  int lo = 0, hi = nkb;
  if (causal) {  // live iff kb·block_k <= qs + block_q - 1
    const int last = qs + block_q - 1;
    hi = last < 0 ? 0 : min(nkb, last / block_k + 1);
  }
  if (window > 0) {  // live iff kb·block_k + block_k - 1 > qs - window
    const int t = qs - window - block_k + 1;
    const int fl = t >= 0 ? t / block_k : -((-t + block_k - 1) / block_k);
    lo = max(0, fl + 1);
  }
  return hi > lo ? Slots{lo * block_k, hi * block_k} : Slots{0, 0};
}

// one work item of a CTA: BQ query rows of one head and batch item, and
// the key tiles of the union of its warpgroups' live slots. Items are
// numbered with q blocks slowest and the last first, so causal's longest
// items come first across every head and batch item.
struct FwdItem {
  int q0, h, b, lo, ntiles;
};
__device__ __forceinline__ FwdItem fwd_item(int i, int batch, int hq, int sq, int sk,
                                            int causal, int window, int block_q,
                                            int block_k) {
  const int hb = batch * hq, nqb = (sq + BQ - 1) / BQ;
  FwdItem it;
  it.q0 = (nqb - 1 - i / hb) * BQ;
  it.h = i % hq;
  it.b = (i % hb) / hq;
  int lo = 0, hi = 0;  // the union; empty ranges are {0, 0}
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    const Slots x = live_slots(it.q0 + 64 * w, sq, sk, causal, window, block_q, block_k);
    if (x.hi > x.lo) {
      lo = hi > lo ? min(lo, x.lo) : x.lo;
      hi = max(hi, x.hi);
    }
  }
  it.lo = lo;
  it.ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  return it;
}

// mask and scale one tile of logits in place (MASK: some key or row of the
// tile needs its own test), then the online-softmax update of the
// thread's two rows; the tile's probabilities replace the logits and corr
// is the factor of the rows' accumulators (applied by the caller). Maxima
// and sums run in four independent chains (the order of a sum of
// probabilities is free: the plain version's is another still).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&corr)[2],
                                             float (&m)[2], float (&l)[2], int k0,
                                             int qpos0, Slots my, int sk, int causal,
                                             int window, float scale_log2, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qpos0 + 8 * i;
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        if (MASK) {  // scaled here; a whole tile scales inside the exponent's FMA
          const int kpos = k0 + 8 * j + 2 * quad + e;
          x = kpos < my.lo || kpos >= my.hi ? -INFINITY  // not a slot
              : flash::valid(qpos, kpos, sk, causal, window) ? x * scale_log2 : NEG;
        }
        mx[j % 4] = fmaxf(mx[j % 4], x);
      }
    float mc = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mc = fmaxf(mc, __shfl_xor_sync(flash::FULL, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(flash::FULL, mc, 2));
    if (!MASK) mc *= scale_log2;  // scale > 0 (the caller's test): the max of the scaled logits
    // the reference max moves only when the row's max passes it by more
    // than 8 (p <= 2^8 otherwise), so most tiles leave O unscaled; from
    // the sentinel -1e30 any valid logit moves it (corr = 2^-1e30 = 0)
    corr[i] = 1.f;
    if (mc > m[i] + 8.f) {
      corr[i] = ex2(m[i] - mc);
      m[i] = mc;
    }
    const float mr = m[i];  // >= NEG: a live tile holds a slot
    float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = MASK ? ex2(x - mr) : ex2(fmaf(x, scale_log2, -mr));
        ps[j % 4] += x;
      }
    l[i] = corr[i] * l[i] + ((ps[0] + ps[1]) + (ps[2] + ps[3]));
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int batch, int hq, int hkv, int sq, int sk,
                int causal, int window, float scale_log2, int block_q, int block_k) {
  using L = Layout<D>;
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + S::BAR);  // [2]
  uint64_t* empty_q = full_q + 2;                                  // [2]
  uint64_t* full_k = empty_q + 2;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  const int nitems = (sq + BQ - 1) / BQ * hq * batch;
  auto item = [&](int i) {
    return fwd_item(i, batch, hq, sq, sk, causal, window, block_q, block_k);
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(full_q + qb, 1);
      mbar_init(empty_q + qb, 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // producer: one thread walks the items, loading ahead
    if (threadIdx.x == NWG * WG) {
      int j = 0, g = 0;  // this CTA's counters of items with tiles, and of tiles
      for (int n = blockIdx.x; n < nitems; n += gridDim.x) {
        const FwdItem it = item(n);
        if (it.ntiles == 0) continue;
        const int qb = j & 1, kvm = it.b * hkv + it.h / (hq / hkv);
        mbar_wait(empty_q + qb, ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(full_q + qb, S::TILE_Q);
#pragma unroll
        for (int c = 0; c < D / L::BOX; ++c)
          tma_load(smem + S::Q + qb * S::TILE_Q + c * BQ * L::ROW, &tq, full_q + qb,
                   c * L::BOX, it.q0, it.b * hq + it.h);
        for (int t = 0; t < it.ntiles; ++t, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty + s, ((g / STAGES) & 1) ^ 1);
          uint8_t* kt = smem + S::KV + 2 * s * S::TILE;
          const int k0 = it.lo + t * BK;
          mbar_expect_tx(full_k + s, S::TILE);
#pragma unroll
          for (int c = 0; c < D / L::BOX; ++c)
            tma_load(kt + c * BK * L::ROW, &tk, full_k + s, c * L::BOX, k0, kvm);
          mbar_expect_tx(full_v + s, S::TILE);
#pragma unroll
          for (int c = 0; c < D / L::BOX; ++c)
            tma_load(kt + S::TILE + c * BK * L::ROW, &tv, full_v + s, c * L::BOX, k0, kvm);
        }
        ++j;
      }
    }
    return;
  }

  // consumers
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r = warp * 16 + lane / 4;  // the thread's rows r and r + 8 of the 64
  const int shift = sk - sq;

  int j = 0, g = 0;
  for (int n = blockIdx.x; n < nitems; n += gridDim.x) {
    // an item with no tiles still writes its rows (o = 0, lse = -1e30)
    const FwdItem it = item(n);
    const int qb = j & 1, row0 = it.q0 + wg * 64, lo = it.lo;
    const Slots my = live_slots(row0, sq, sk, causal, window, block_q, block_k);
    const uint32_t qtile = smem_u32(smem + S::Q + qb * S::TILE_Q);
    float acc[D / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
    if (it.ntiles > 0) mbar_wait(full_q + qb, (j >> 1) & 1);

    for (int t = 0; t < it.ntiles; ++t, ++g) {
      const int s = g % STAGES;
      const uint32_t ph = (g / STAGES) & 1;
      const int k0 = lo + t * BK;
      const uint32_t kt = smem_u32(smem + S::KV + 2 * s * S::TILE), vt = kt + S::TILE;
      mbar_wait(full_k + s, ph);
      if (k0 < my.hi && k0 + BK > my.lo) {  // the tile holds a slot of this warpgroup
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<BK>(sc, L::kmajor(qtile, BQ, wg * 64, kk), L::kmajor(kt, BK, 0, kk),
                     kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        // a scale <= 0 sends every tile through the masked path, which
        // scales each logit before the row's max
        const bool whole = scale_log2 > 0.f && k0 >= my.lo && k0 + BK <= my.hi &&
                           k0 + BK <= sk && row0 + 64 <= sq &&
                           (!causal || k0 + BK - 1 <= row0 + shift) &&
                           (window <= 0 || k0 > row0 + 63 + shift - window);
        const int qpos0 = row0 + r + shift;
        float corr[2];
        if (whole)
          softmax_tile<false>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                                  scale_log2, quad);
        else
          softmax_tile<true>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                                 scale_log2, quad);
        if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            acc[4 * c] *= corr[0];
            acc[4 * c + 1] *= corr[0];
            acc[4 * c + 2] *= corr[1];
            acc[4 * c + 3] *= corr[1];
          }
        }
        uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) a_split(sc, kk, phi[kk], plo[kk]);
        mbar_wait(full_v + s, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          mma_rs<D>(acc, phi[kk], L::mnmajor(vt, BK, kk), 1);
          mma_rs<D>(acc, plo[kk], L::mnmajor(vt, BK, kk), 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        fence_regs(phi);
        fence_regs(plo);
      } else {
        mbar_wait(full_v + s, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    if (it.ntiles > 0 && lane == 0) mbar_arrive(empty_q + qb);  // Q's products are done

    const long long mat = static_cast<long long>(it.b) * hq + it.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(flash::FULL, l[i], 1);
      l[i] += __shfl_xor_sync(flash::FULL, l[i], 2);
      const int row = row0 + r + 8 * i;
      if (row >= sq) continue;
      const float denom = l[i] == 0.f ? 1.f : l[i], inv = 1.f / denom;
      __nv_bfloat16* orow = o + (mat * sq + row) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * quad) = __floats2bfloat162_rn(
            acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
      if (quad == 0) lse[mat * sq + row] = (m[i] == NEG ? NEG : m[i] * LN2) + logf(denom);
    }
    j += it.ntiles > 0;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int sk, int causal, int window, float scale,
           int block_q, int block_k, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = tile_map(&tq, q, batch * hq, sq, D, BQ);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, D, BK);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, D, BK);
  if (e) return e;
  constexpr int smem = FwdSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_fwd_wgmma<D>>(smem, &sms);
  if (e) return e;
  // persistent: at most one CTA per SM, each walking items blockIdx.x + k·gridDim.x
  const int nitems = (sq + BQ - 1) / BQ * hq * batch;
  const int grid = nitems < sms ? nitems : sms;
  flash_fwd_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, batch, hq, hkv, sq, sk, causal,
      window, scale * LOG2E, block_q, block_k);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
             int hq, int hkv, int sq, int sk, int d, int causal, int window, float scale,
             int block_q, int block_k, cudaStream_t st) {
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 32: return launch<32>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 64: return launch<64>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    case 128: return launch<128>(q, k, v, o, lse, batch, hq, hkv, sq, sk, causal, window, scale, block_q, block_k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// q, o: (batch, hq, sq, d); k, v: (batch, hkv, sk, d), all contiguous and
// of one type, float32 (bf16 = 0) or bf16 (bf16 = 1); lse: (batch, hq, sq)
// float32. window <= 0 means none. block_q/block_k are the emulated TPU
// blocks (min(128, sq), min(128, sk)); block_q is a multiple of 64 or equals
// sq. d is 16, 32, 64 or 128. Returns a cudaError_t.
REPRO_EXPORT int flash_fwd(const void* q, const void* k, const void* v, void* o,
                           float* lse, int batch, int hq, int hkv, int sq,
                           int sk, int d, int causal, int window, float scale,
                           int block_q, int block_k, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)  // the tensor-core kernel only: no bf16 input reaches the SIMT one
    return tc::dispatch(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal,
                        window, scale, block_q, block_k, st);
  return dispatch<float>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal,
                         window, scale, block_q, block_k, st);
}
