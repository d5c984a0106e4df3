// flash_fwd.cu — attention forward by online softmax, one CTA per (q tile of
// 64 rows, query head, batch item); q/k/v float32 or bf16, math in float32.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py: _fwd_call
// (pallas_call at :145, body _flash_kernel at :75). It computes the same
// (o, lse): q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D) and
// lse (B, Hq, Sq), with queries right-aligned to the keys (absolute position
// i + Sk - Sq), causal and sliding-window masks, and GQA through the kv head
// h / (Hq / Hkv).
//
// What the TPU kernel's grid did, and what this design does instead:
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
// slots at all (p = 0). l == 0 becomes 1; lse = m + log(l). expf/logf, never
// the fast intrinsics; no tensor cores, so no TF32.
//
// bf16 inputs (the trainer's compute type) are widened to float32 as they
// are staged into shared memory and o is rounded back to bf16 at the store,
// as the TPU kernel's .astype(f32) / .astype(o_ref.dtype) do; lse stays
// float32. The float32 instantiation is the same code with identity casts.
//
// Bound: at the harvest's shape (4, 32, 2048, 64) f32 causal the work is
// 2·B·Hq·Sq·Sk·D ≈ 68.7 GFLOP against 134 MB of q, k, v and o, so the
// kernel is bound by float32 operations (67 TFLOP/s outside the tensor
// cores), not bytes. The score and P·V loops are the whole cost; this
// simple SIMT kernel keeps them on FMAs fed from shared memory.
#include <math.h>

#include "flash_common.cuh"

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
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                                   causal, window, scale, block_q, block_k, st);
  return dispatch<float>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, causal,
                         window, scale, block_q, block_k, st);
}
