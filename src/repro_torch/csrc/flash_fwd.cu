// flash_fwd.cu — attention forward by online softmax on Hopper's tensor
// cores: a bf16 kernel (the trainer's compute type) and a float32 kernel
// that holds float32 accuracy with three TF32 products per product
// (namespace tc). Both are fed by TMA and run persistent CTAs.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py: _fwd_call
// (pallas_call at :145, body _flash_kernel at :75). It computes the same
// (o, lse): q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D) and
// lse (B, Hq, Sq), with queries right-aligned to the keys (absolute position
// i + Sk - Sq), causal and sliding-window masks, and GQA through the kv head
// h / (Hq / Hkv). A head dim d (a multiple of 8 up to 128) runs the kernels
// instantiated at the next width up, D = 16, 32, 64 or 128
// (flash::padded_width): the tensor maps describe q, k and v at their true
// d, so a box's columns past d read as 0, and o is stored at row stride d
// with those columns left out; the float32 kernel's pre-pass writes its
// planes at width d.
//
// What the TPU kernel's grid did, and what these kernels do instead: the
// sequential ("arbitrary") k grid axis becomes a loop over key tiles inside
// the CTA, the running max m, denominator l and the accumulator in
// registers; dead blocks are skipped by bounding that loop with the TPU
// kernel's own liveness rule evaluated on its (block_q, block_k) =
// (min(128, Sq), min(128, Sk)) blocks, passed in by the wrapper (causal
// stops after the last live k block, a window starts at the first live one).
//
// Numerics follow the TPU kernel, including its corner cases: masked
// logits are -1e30 (not -inf), so a row that is masked across a whole live
// block gets p = exp(0) = 1 there until a valid key's correction exp(m - m')
// wipes it; a row that no key reaches (causal with Sq > Sk) keeps those
// terms, averaging V over the slots of the live blocks (the zeroed ragged
// tail of the last k block included). Keys past the live blocks are not
// slots at all (p = 0). l == 0 becomes 1; lse = m + log(l). o is rounded to
// the input type at the store, lse stays float32.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

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
// it.lo and it.ntiles: the tiles of TILE keys over the union of the live
// slots of the item's WGS warpgroups of 64 rows from it.q0
template <int WGS, int TILE>
__device__ __forceinline__ void item_tiles(FwdItem& it, int sq, int sk, int causal,
                                           int window, int block_q, int block_k) {
  int lo = 0, hi = 0;  // the union; empty ranges are {0, 0}
#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    const Slots x = live_slots(it.q0 + 64 * w, sq, sk, causal, window, block_q, block_k);
    if (x.hi > x.lo) {
      lo = hi > lo ? min(lo, x.lo) : x.lo;
      hi = max(hi, x.hi);
    }
  }
  it.lo = lo;
  it.ntiles = hi > lo ? (hi - lo + TILE - 1) / TILE : 0;
}
__device__ __forceinline__ FwdItem fwd_item(int i, int batch, int hq, int sq, int sk,
                                            int causal, int window, int block_q,
                                            int block_k) {
  const int hb = batch * hq, nqb = (sq + BQ - 1) / BQ;
  FwdItem it;
  it.q0 = (nqb - 1 - i / hb) * BQ;
  it.h = i % hq;
  it.b = (i % hb) / hq;
  item_tiles<NWG, BK>(it, sq, sk, causal, window, block_q, block_k);
  return it;
}

// whether a tile of TILE keys from k0 needs no test per logit for the 64
// rows from row0: every key a live slot of theirs inside the keys, every
// row inside the rows, no pair masked, and scale > 0 (a scale <= 0 sends
// every tile through the masked path, which scales each logit before the
// row's max)
template <int TILE>
__device__ __forceinline__ bool whole_tile(float scale_log2, int k0, Slots my, int sk,
                                           int sq, int row0, int shift, int causal,
                                           int window) {
  return scale_log2 > 0.f && k0 >= my.lo && k0 + TILE <= my.hi && k0 + TILE <= sk &&
         row0 + 64 <= sq && (!causal || k0 + TILE - 1 <= row0 + shift) &&
         (window <= 0 || k0 > row0 + 63 + shift - window);
}

// the rows' accumulators times their online-softmax corrections
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
  if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      acc[4 * c] *= corr[0];
      acc[4 * c + 1] *= corr[0];
      acc[4 * c + 2] *= corr[1];
      acc[4 * c + 3] *= corr[1];
    }
  }
}

// mask and scale one tile of logits in place (MASK: some key or row of the
// tile needs its own test), then the online-softmax update of the
// thread's two rows; the tile's probabilities replace the logits and corr
// is the factor of the rows' accumulators (applied by the caller). Maxima
// and sums run in four independent chains (the order of a sum of
// probabilities is free: the plain version's is another still). NS = 2 ·
// (keys of the tile) / 4 accumulator registers of an m64n{keys} product.
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&corr)[2],
                                             float (&m)[2], float (&l)[2], int k0,
                                             int qpos0, Slots my, int sk, int causal,
                                             int window, float scale_log2, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qpos0 + 8 * i;
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
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
    for (int j = 0; j < NS / 4; ++j)
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
                float* __restrict__ lse, int batch, int hq, int hkv, int sq, int sk, int d,
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
        const bool whole =
            whole_tile<BK>(scale_log2, k0, my, sk, sq, row0, shift, causal, window);
        const int qpos0 = row0 + r + shift;
        float corr[2];
        if (whole)
          softmax_tile<false>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                                  scale_log2, quad);
        else
          softmax_tile<true>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                                 scale_log2, quad);
        rescale(acc, corr);
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
      __nv_bfloat16* orow = o + (mat * sq + row) * d;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        if (8 * c < d)  // columns past d are the padding's zeros
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * quad) = __floats2bfloat162_rn(
              acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
      if (quad == 0) lse[mat * sq + row] = (m[i] == NEG ? NEG : m[i] * LN2) + logf(denom);
    }
    j += it.ntiles > 0;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int sk, int d, int causal, int window, float scale,
           int block_q, int block_k, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  int e = tile_map(&tq, q, batch * hq, sq, d, BQ, 2, L::BOX);
  if (!e) e = tile_map(&tk, k, batch * hkv, sk, d, BK, 2, L::BOX);
  if (!e) e = tile_map(&tv, v, batch * hkv, sk, d, BK, 2, L::BOX);
  if (e) return e;
  constexpr int smem = FwdSmem<D>::BYTES;
  int sms = 0;
  e = prepare<flash_fwd_wgmma<D>>(smem, &sms);
  if (e) return e;
  // persistent: at most one CTA per SM, each walking items blockIdx.x + k·gridDim.x
  const int nitems = (sq + BQ - 1) / BQ * hq * batch;
  const int grid = nitems < sms ? nitems : sms;
  flash_fwd_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, batch, hq, hkv, sq, sk, d, causal,
      window, scale * LOG2E, block_q, block_k);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
             int hq, int hkv, int sq, int sk, int d, int causal, int window, float scale,
             int block_q, int block_k, cudaStream_t st) {
  switch (flash::padded_width(d)) {
    case 16: return launch<16>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 32: return launch<32>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 64: return launch<64>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 128: return launch<128>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------- float32: 3×TF32 on the tensor cores
// One TF32 product keeps 11 bits of each operand, far outside the float32
// bar, so each product is three: big·big + big·small + small·big, with
// big = tf32(x) and small = tf32(x - big) rounded to nearest
// (hopper::tf32_split), summed in float32; the dropped small·small and the
// rounding of small leave about 2^-21 of each term, the level of a float32
// sum in another order. A pre-pass (hopper::tf32_planes, tf32_planes_vt)
// writes each operand's two terms to a scratch buffer the wrapper allocates: Q
// and K as they are, V transposed to (D, keys) because wgmma reads TF32
// operands K-major only, its keys permuted within each group of 8 (slot c
// holds key 2c for c < 4, 2(c - 4) + 1 above) so that P enters O += P V
// straight from the S accumulator: a thread's accumulator holds keys
// 2t, 2t + 1 of each group of 8 where the tf32 A fragment wants columns
// t, t + 4, and the sum over keys does not depend on their order.
//
// The kernel is the bf16 kernel's shape at the operands' doubled size: a
// producer warp fills Q's two planes and a ring of STAGES K/V stages (K
// big, K small, Vᵀ big, Vᵀ small) by TMA; NWG consumer warpgroups of 64 rows
// run, per tile, S = Q Kᵀ (3 · D/8 wgmma m64n{BK}k8, both operands in shared
// memory), the same online softmax (ex2 on logits scaled by scale · log2 e,
// the max moving only past a jump of 8), and O += P V (3 · BK/8 wgmma
// m64n{D}k8, P's two terms from registers, into fresh accumulators added
// to O in float32: chained over every tile in one wgmma accumulator, O
// drifted from its float32 sum, and where the values share most of their
// value (v̄ + 0.01·ε) that drift is a large part of O − v̄, which the
// backward's delta = rowsum(dO ∘ O) carries into dK: 2.1e-03 of its
// largest entry from float64 at whisper's cross shape, 6e-05 this way,
// chip_smoke.py phase 13). Shared memory holds one Q
// buffer; the next item's Q loads once both warpgroups are done with this
// one. Items of NWG · 64 rows are handed out by an atomic counter in
// order of groups of HG heads, each group's q blocks last first, so the
// K/V planes of the heads in flight (2 MB a head at the harvest's shape)
// stay in L2 while the card works through their rows.
//
// Bound: at the harvest's (4, 32, 2048, 64) causal the two products are
// 68.7 GFLOP of float32 work, 139 µs at 494.7 TFLOP/s of TF32; the split
// issues three times that (206 GFLOP, 417 µs). The pre-pass moves 604 MB
// (180 µs at 3.35 TB/s).
template <int D>
struct F32Fwd {
  static constexpr int NWG = D == 128 ? 1 : 2;          // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                   // query rows per item
  static constexpr int BK = D == 128 ? 32 : 64;         // keys per tile
  static constexpr int THREADS = NWG * WG + 32;
  static constexpr int HG = 8;                          // heads per item group
  static constexpr int QROW = (D < 32 ? D : 32) * 4;    // bytes of a Q/K box row
  static constexpr int TILE_Q = BQ * D * 4;             // one plane of Q
  static constexpr int TILE = BK * D * 4;               // one plane of K or of Vᵀ
  static constexpr int STAGES = D == 16 ? 8 : D == 32 ? 5 : 2;
  static constexpr int Q = 0;                           // Q big, Q small
  static constexpr int KV = 2 * TILE_Q;                 // stage s: K b/s, Vᵀ b/s
  static constexpr int BAR = KV + STAGES * 4 * TILE;
  static constexpr int SLOT = BAR + 8 * (2 + 3 * STAGES);  // the item handed out
  static constexpr int BYTES = SLOT + 16 + 1024;        // + alignment
};

// the work item numbered i (< batch · hq · nqb): groups of HG heads, each
// group's q blocks last first across its heads
template <int D>
__device__ __forceinline__ FwdItem f32_item(int i, int batch, int hq, int sq, int sk,
                                            int causal, int window, int block_q,
                                            int block_k) {
  using C = F32Fwd<D>;
  const int hb = batch * hq, nqb = (sq + C::BQ - 1) / C::BQ;
  const int grp = i / (C::HG * nqb), r = i % (C::HG * nqb);
  const int hg = min(C::HG, hb - grp * C::HG), head = grp * C::HG + r % hg;
  FwdItem it;
  it.q0 = (nqb - 1 - r / hg) * C::BQ;
  it.h = head % hq;
  it.b = head / hq;
  item_tiles<C::NWG, C::BK>(it, sq, sk, causal, window, block_q, block_k);
  return it;
}

template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
               float* __restrict__ lse, int* __restrict__ counter, int batch, int hq,
               int hkv, int sq, int sk, int d, int causal, int window, float scale_log2,
               int block_q, int block_k) {
  using C = F32Fwd<D>;
  using KQ = KMajor<C::QROW>;  // Q and K tiles: boxes of [rows][QROW / 4]
  using VT = KMajor<128>;      // Vᵀ tiles: boxes of [D][32 keys]
  constexpr int NWG = C::NWG, BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  constexpr int QBOX = C::QROW / 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  volatile int* slot = reinterpret_cast<int*>(smem + C::SLOT);
  const int nitems = (sq + BQ - 1) / BQ * hq * batch;
  auto item = [&](int i) {
    return f32_item<D>(i, batch, hq, sq, sk, causal, window, block_q, block_k);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * NWG);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // producer: one thread takes items and loads ahead
    if (threadIdx.x == NWG * WG) {
      const int qmats = batch * hq, kvmats = batch * hkv;  // a plane's matrices
      int g = 0;  // this CTA's tiles so far
      for (int n = blockIdx.x, j = 0;; n = gridDim.x + atomicAdd(counter, 1), ++j) {
        mbar_wait(empty_q, (j & 1) ^ 1);
        const bool live = n < nitems;
        const FwdItem it = item(live ? n : 0);
        *slot = live ? n : -1;  // published by the arrival below
        mbar_expect_tx(full_q, live && it.ntiles > 0 ? 2 * C::TILE_Q : 0);
        if (!live) break;
        if (it.ntiles == 0) continue;
        const int kvm = it.b * hkv + it.h / (hq / hkv);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int c = 0; c < D / QBOX; ++c)
            tma_load(smem + C::Q + pl * C::TILE_Q + c * BQ * C::QROW, &tq, full_q,
                     c * QBOX, it.q0, pl * qmats + it.b * hq + it.h);
        for (int t = 0; t < it.ntiles; ++t, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty + s, ((g / STAGES) & 1) ^ 1);
          uint8_t* st = smem + C::KV + s * 4 * C::TILE;
          const int k0 = it.lo + t * BK;
          mbar_expect_tx(full_k + s, 2 * C::TILE);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
#pragma unroll
            for (int c = 0; c < D / QBOX; ++c)
              tma_load(st + pl * C::TILE + c * BK * C::QROW, &tk, full_k + s, c * QBOX, k0,
                       pl * kvmats + kvm);
          mbar_expect_tx(full_v + s, 2 * C::TILE);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
#pragma unroll
            for (int c = 0; c < BK / 32; ++c)
              tma_load(st + (2 + pl) * C::TILE + c * D * 128, &tv, full_v + s, k0 + 32 * c,
                       0, pl * kvmats + kvm);
        }
      }
    }
    return;
  }

  // consumers
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r = warp * 16 + lane / 4;  // the thread's rows r and r + 8 of the 64
  const int shift = sk - sq;
  const uint32_t qb = smem_u32(smem + C::Q), qs = qb + C::TILE_Q;

  int g = 0;
  for (int j = 0;; ++j) {
    mbar_wait(full_q, j & 1);
    const int n = *slot;
    if (n < 0) break;
    // an item with no tiles still writes its rows (o = 0, lse = -1e30)
    const FwdItem it = item(n);
    const int row0 = it.q0 + wg * 64, lo = it.lo;
    const Slots my = live_slots(row0, sq, sk, causal, window, block_q, block_k);
    float acc[D / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

    for (int t = 0; t < it.ntiles; ++t, ++g) {
      const int s = g % STAGES;
      const uint32_t ph = (g / STAGES) & 1;
      const int k0 = lo + t * BK;
      const uint32_t kb = smem_u32(smem + C::KV + s * 4 * C::TILE), ks = kb + C::TILE;
      const uint32_t vb = kb + 2 * C::TILE, vs = kb + 3 * C::TILE;
      mbar_wait(full_k + s, ph);
      if (k0 < my.hi && k0 + BK > my.lo) {  // the tile holds a slot of this warpgroup
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {  // small terms first, then big · big
          const uint64_t ab = KQ::kmajor(qb, BQ, wg * 64, kk);
          const uint64_t bb = KQ::kmajor(kb, BK, 0, kk);
          mma_ss_tf32<BK>(sc, KQ::kmajor(qs, BQ, wg * 64, kk), bb, kk > 0);
          mma_ss_tf32<BK>(sc, ab, KQ::kmajor(ks, BK, 0, kk), 1);
          mma_ss_tf32<BK>(sc, ab, bb, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        const bool whole =
            whole_tile<BK>(scale_log2, k0, my, sk, sq, row0, shift, causal, window);
        const int qpos0 = row0 + r + shift;
        float corr[2];
        if (whole)
          softmax_tile<false>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                              scale_log2, quad);
        else
          softmax_tile<true>(sc, corr, m, l, k0, qpos0, my, sk, causal, window,
                             scale_log2, quad);
        rescale(acc, corr);
        uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) tf32_frag(sc, kk, pb[kk], ps[kk]);
        mbar_wait(full_v + s, ph);
        float part[D / 2];  // this tile's P V, added to acc in float32
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t bb = VT::kmajor(vb, D, 0, kk);
          mma_rs_tf32<D>(part, ps[kk], bb, kk > 0);
          mma_rs_tf32<D>(part, pb[kk], VT::kmajor(vs, D, 0, kk), 1);
          mma_rs_tf32<D>(part, pb[kk], bb, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(part);
        fence_regs(pb);
        fence_regs(ps);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) acc[c] += part[c];
      } else {
        mbar_wait(full_v + s, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_q);  // Q's products are done, the slot read

    const long long mat = static_cast<long long>(it.b) * hq + it.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(flash::FULL, l[i], 1);
      l[i] += __shfl_xor_sync(flash::FULL, l[i], 2);
      const int row = row0 + r + 8 * i;
      if (row >= sq) continue;
      const float denom = l[i] == 0.f ? 1.f : l[i], inv = 1.f / denom;
      float* orow = o + (mat * sq + row) * d;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        if (8 * c < d)  // columns past d are the padding's zeros
          *reinterpret_cast<float2*>(orow + 8 * c + 2 * quad) =
              make_float2(acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
      if (quad == 0) lse[mat * sq + row] = (m[i] == NEG ? NEG : m[i] * LN2) + logf(denom);
    }
  }
}

// The float32 forward's scratch, in floats: the two tf32 terms of Q and K,
// of Vᵀ with its keys padded to a multiple of 32, and 4 floats that hold the
// item counter (launch_tf32 carves it in this order; the export checks the
// caller's buffer against it).
struct Tf32Work {
  long long nq, nk, nv;
  int skp;
  Tf32Work(int batch, int hq, int hkv, int sq, int sk, int d)
      : nq(static_cast<long long>(batch) * hq * sq * d),
        nk(static_cast<long long>(batch) * hkv * sk * d),
        nv(static_cast<long long>(batch) * hkv * d * ((sk + 31) / 32 * 32)),
        skp((sk + 31) / 32 * 32) {}
  long long floats() const { return 2 * (nq + nk + nv) + 4; }
};

template <int D>
int launch_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                float* work, int batch, int hq, int hkv, int sq, int sk, int d, int causal,
                int window, float scale, int block_q, int block_k, cudaStream_t stream) {
  using C = F32Fwd<D>;
  const Tf32Work w(batch, hq, hkv, sq, sk, d);
  const long long nq = w.nq, nk = w.nk, nv = w.nv;
  const int skp = w.skp;
  float* qp = work;       // Q big, Q small: (2 · batch · hq, sq, d)
  float* kp = qp + 2 * nq;  // K big, K small: (2 · batch · hkv, sk, d)
  float* vp = kp + 2 * nk;  // Vᵀ big, Vᵀ small: (2 · batch · hkv, d, skp)
  int* counter = reinterpret_cast<int*>(vp + 2 * nv);
  planes(q, qp, nq, counter, stream);
  planes(k, kp, nk, nullptr, stream);
  planes_t(v, vp, batch * hkv, sk, skp, d, stream);
  cudaError_t e0 = cudaGetLastError();
  if (e0) return e0;
  CUtensorMap tq, tk, tv;  // boxes of the instantiated width D over the true d
  int e = tile_map(&tq, qp, 2 * batch * hq, sq, d, C::BQ, 4, C::QROW / 4);
  if (!e) e = tile_map(&tk, kp, 2 * batch * hkv, sk, d, C::BK, 4, C::QROW / 4);
  if (!e) e = tile_map(&tv, vp, 2 * batch * hkv, d, skp, D, 4);
  if (e) return e;
  constexpr int smem = C::BYTES;
  int sms = 0;
  e = prepare<flash_fwd_tf32<D>>(smem, &sms);
  if (e) return e;
  // persistent: at most one CTA per SM; items past the first from the counter
  const int nitems = (sq + C::BQ - 1) / C::BQ * hq * batch;
  const int grid = nitems < sms ? nitems : sms;
  flash_fwd_tf32<D><<<grid, C::THREADS, smem, stream>>>(
      tq, tk, tv, o, lse, counter, batch, hq, hkv, sq, sk, d, causal, window, scale * LOG2E,
      block_q, block_k);
  return cudaGetLastError();
}

int dispatch_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                  float* work, int batch, int hq, int hkv, int sq, int sk, int d, int causal,
                  int window, float scale, int block_q, int block_k, cudaStream_t st) {
  switch (flash::padded_width(d)) {
    case 16: return launch_tf32<16>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 32: return launch_tf32<32>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 64: return launch_tf32<64>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    case 128: return launch_tf32<128>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk, d, causal, window, scale, block_q, block_k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// q, o: (batch, hq, sq, d); k, v: (batch, hkv, sk, d), all contiguous and
// of one type, float32 (bf16 = 0) or bf16 (bf16 = 1); lse: (batch, hq, sq)
// float32. work: float32 scratch of work_floats floats, at least
// tc::Tf32Work::floats() (float32 only; null and 0 for bf16). window <= 0
// means none. block_q/block_k are the emulated TPU
// blocks (min(128, sq), min(128, sk)); block_q is a multiple of 64 or equals
// sq. d is a multiple of 8 from 8 to 128 (flash::padded_width: the kernels
// of the next width up run on it). Both types run on the tensor cores.
// Returns a cudaError_t.
REPRO_EXPORT int flash_fwd(const void* q, const void* k, const void* v, void* o,
                           float* lse, void* work, long long work_floats,
                           int batch, int hq, int hkv, int sq, int sk, int d,
                           int causal, int window,
                           float scale, int block_q, int block_k, int bf16,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::dispatch(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal,
                        window, scale, block_q, block_k, st);
  if (work == nullptr || work_floats < tc::Tf32Work(batch, hq, hkv, sq, sk, d).floats())
    return cudaErrorInvalidValue;
  return tc::dispatch_tf32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), lse,
                           static_cast<float*>(work), batch, hq, hkv, sq, sk, d, causal,
                           window, scale, block_q, block_k, st);
}
