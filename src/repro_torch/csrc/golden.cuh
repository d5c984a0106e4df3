// golden.cuh — pieces shared by the hand-written golden kernels of the
// paper's Algorithms 2 and 5 (bilevel_l1inf.cu, trilevel_l1infinf.cu):
// storage types, 16-byte vector access, the NaN-propagating clip (on
// common.cuh's max_nan / min_nan), the fold of loaded packs into column
// maxima, and the stream that clips Y to a per-element radius (`clip` and
// `trilevel_apply`).
//
// These kernels are an independent second implementation of what the
// generated pipeline (codegen_reduce.cu, codegen_apply.cu) computes for the
// bi-level and tri-level ℓ1,∞ designs, so they share none of its bodies.
//
// Storage: float32 (`float`) or bf16 kept as its raw bits (`unsigned short`).
// Every value the golden kernels write is one of their inputs' values, its
// negation, or NaN (maxima, clips, minima: no arithmetic rounds), so the
// bf16 narrowing below is a truncation of the widened bits and is exact.
#pragma once

#include <string.h>

#include "common.cuh"

namespace golden {

enum : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // kernels/bilevel_l1inf.py

using bf16_bits = unsigned short;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <typename S>
__device__ __forceinline__ S narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_bits narrow<bf16_bits>(float x) {
  return static_cast<bf16_bits>(__float_as_uint(x) >> 16);
}

// clip(y, -u, u) = min(max(y, -u), u), jnp.clip's order of operations
__device__ __forceinline__ float clip_nan(float y, float u) {
  return min_nan(max_nan(y, -u), u);
}

// VEC consecutive elements of one row; VEC * sizeof(S) == 16 makes every
// access one 16-byte load or store (the wrapper checks the alignment).
template <typename S, int VEC>
struct alignas(VEC * sizeof(S)) Pack {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> load(const S* p) {
  return *reinterpret_cast<const Pack<S, VEC>*>(p);
}

template <typename S, int VEC>
__device__ __forceinline__ void store(S* p, const Pack<S, VEC>& x) {
  *reinterpret_cast<Pack<S, VEC>*>(p) = x;
}

// acc[k] = max(acc[k], |x[u].v[k]|) over the loaded packs, NaN kept
template <typename S, int VEC, int LOADS>
__device__ __forceinline__ void fold_abs_max(float (&acc)[VEC],
                                             const Pack<S, VEC> (&x)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = max_nan(acc[k], fabsf(widen(x[u].v[k])));
}

// ----------------------------------------- the stream of `clip` and `apply`
//
// X = clip(Y, ±r) over c planes of n · m elements (c = 1 for `clip`), r a
// radius per element of the plane, the same for every plane: u[j] for
// `clip`, min(v2[i, j], u1[j]) for `trilevel_apply` (the kernels'
// `Radius`). The plane is streamed as one run of packs, not by column
// strips, so a pack may straddle the end of a row: its elements take the
// columns j, j + 1, … wrapping at m (column_radius), and only the tensors'
// base pointers decide whether packs are 16 bytes wide (VEC > 1) or one
// element (VEC = 1).
//
// One CTA of STREAM_THREADS threads per unit: a tile of STREAM_TILE packs
// of the plane (8 KB of float32 or bf16) and a group of planes (g, g +
// groups, …; the wrapper picks `groups`: kernels/bilevel_l1inf.py:
// stream_shape), CTA b taking tile b % tiles of group b / tiles, so
// consecutive CTAs read consecutive tiles and the block scheduler hands
// the next unit to whichever SM frees a slot first. Thread t reads the
// radii of its packs t and t + STREAM_THREADS of the tile once and holds
// them in registers across the group's planes (v2 is read once per group,
// not once per plane), then, plane by plane, issues its loads of Y before
// it clips any and stores X with the streaming hint (st.global.cs). The
// column of a thread's first pack takes one division; the second steps by
// STREAM_THREADS · VEC mod m. A ragged last pack (plane % VEC elements)
// runs element by element in the last tile.
//
// Why many small CTAs: on an H100 (700 W; scripts/time_ab.py golden on
// variant trees, 20-call replay per call, W1 / W3 clip and W2 / W4 apply
// in µs; PERF.md § 6, PR 22) this stream read 46.9 / 29.9 / 48.6 / 185.8,
// one CTA per unit with 1 or 4 packs a thread 48.4 / 30.2 / 48.5 / 183.2
// and 47.3 / 30.2 / 48.2 / 189.1, and the old column-strip kernels 49.2 /
// 30.6 / 50.9 / 198.8; one wave of persistent CTAs, each a run of the
// plane, read 51.5 / 31.1 / 51.4 / 184.7 with a ring of 32 KB bulk copies
// (cp.async.bulk, mbarriers) and 51.2 / 33.0 / 53.2 / 196.1 with 8 loads a
// thread, and 53.1 / 30.8 / 52.4 / 185.7 striding the units. A static
// split leaves the slowest SM's share as the tail; `copy_` of the same
// bytes reads W1 in 46.4.
constexpr int STREAM_THREADS = 256;  // bilevel_l1inf.STREAM_THREADS
constexpr int STREAM_PACKS = 2;      // packs per thread of a tile
constexpr int STREAM_TILE = STREAM_THREADS * STREAM_PACKS;  // bilevel_l1inf.STREAM_TILE

// CTAs resident per SM the registers must allow (float32 6, bf16 4: its
// radii widen from packs of 8)
template <typename S>
constexpr int stream_min_ctas() { return sizeof(S) == 4 ? 6 : 4; }

// a pack of Y read once: the non-coherent path, not kept in L1
template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> load_stream(const S* p) {
  Pack<S, VEC> out;
  if constexpr (VEC * sizeof(S) == 16) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    memcpy(&out, &r, 16);
  } else {
    static_assert(VEC == 1, "a pack is 16 bytes or one element");
    out.v[0] = __ldcs(p);
  }
  return out;
}

// a pack of X written once: evict-first (st.global.cs)
template <typename S, int VEC>
__device__ __forceinline__ void store_stream(S* p, const Pack<S, VEC>& v) {
  if constexpr (VEC * sizeof(S) == 16) {
    uint4 r;
    memcpy(&r, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), r);
  } else {
    __stcs(p, v.v[0]);
  }
}

// u[j], u[j + 1], … for one pack, the column wrapping at m; one 16-byte
// load when the pack starts a 16-byte aligned run inside a row (u is
// 16-byte aligned whenever VEC > 1)
template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> column_radius(const S* __restrict__ u,
                                                      int j, int m) {
  if (VEC > 1 && j % VEC == 0 && j + VEC <= m) return load<S, VEC>(u + j);
  Pack<S, VEC> r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    r.v[k] = u[j];
    if (++j == m) j = 0;
  }
  return r;
}

template <typename S, int VEC>
__device__ __forceinline__ void clip_pack(Pack<S, VEC>& v, const Pack<S, VEC>& r) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) v.v[k] = narrow<S>(clip_nan(widen(v.v[k]), widen(r.v[k])));
}

// `radius.pack(f, j)`: the radii of the whole pack at plane offset f, whose
// first column is j; `radius.one(e, j)`: the radius of element e alone
template <typename S, int VEC, class Radius>
__device__ __forceinline__ void stream_clip(const S* __restrict__ y,
                                            S* __restrict__ x,
                                            const Radius& radius, int c, int m,
                                            long long plane, int groups) {
  const long long packs = (plane + VEC - 1) / VEC, whole = plane / VEC;
  const long long tiles = (packs + STREAM_TILE - 1) / STREAM_TILE;
  const long long tile = blockIdx.x % tiles;
  const long long q = tile * STREAM_TILE + threadIdx.x;
  const long long q1 = min(whole, tile * STREAM_TILE + STREAM_TILE);
  Pack<S, VEC> r[STREAM_PACKS];
  int j = static_cast<int>(q * VEC % m);
  const int jstep = static_cast<int>(static_cast<long long>(STREAM_THREADS) * VEC % m);
#pragma unroll
  for (int u = 0; u < STREAM_PACKS; ++u) {
    if (q + u * STREAM_THREADS < q1) r[u] = radius.pack((q + u * STREAM_THREADS) * VEC, j);
    j += jstep;
    if (j >= m) j -= m;
  }
  const long long e = whole * VEC + threadIdx.x;  // the ragged last pack's
  const bool ragged = whole < packs && tile == tiles - 1 && e < plane;
  for (int l = static_cast<int>(blockIdx.x / tiles); l < c; l += groups) {
    const S* yl = y + l * plane + q * VEC;
    S* xl = x + l * plane + q * VEC;
    Pack<S, VEC> v[STREAM_PACKS];
#pragma unroll
    for (int u = 0; u < STREAM_PACKS; ++u)
      if (q + u * STREAM_THREADS < q1) v[u] = load_stream<S, VEC>(yl + u * STREAM_THREADS * VEC);
#pragma unroll
    for (int u = 0; u < STREAM_PACKS; ++u) {
      if (q + u * STREAM_THREADS < q1) {
        clip_pack<S, VEC>(v[u], r[u]);
        store_stream<S, VEC>(xl + u * STREAM_THREADS * VEC, v[u]);
      }
    }
    if (ragged)
      x[l * plane + e] = narrow<S>(clip_nan(
          widen(y[l * plane + e]), radius.one(e, static_cast<int>(e % m))));
  }
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// the stream's grid: one CTA per (tile, group of planes)
inline long long stream_ctas(long long plane, int vec, int groups) {
  return ((plane + vec - 1) / vec + STREAM_TILE - 1) / STREAM_TILE * groups;
}

}  // namespace golden
