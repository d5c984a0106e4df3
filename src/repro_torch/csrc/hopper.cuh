// hopper.cuh — the PTX pieces of the tensor-core kernels (sm_90a): shared
// addresses, mbarriers, TMA tile loads and the tensor maps they read,
// wgmma descriptors, issue, fences and waits, the two-term bf16 split of a
// float32 operand, and the tf32 products and two-term tf32 split of the
// float32 (3×TF32) kernels, with their pre-pass.
//
// Tiles. A (rows, D) bf16 tile is loaded by TMA as D / BOX boxes of
// [rows][BOX] with BOX = min(D, 64) columns, each box a row of BOX · 2 =
// 32, 64 or 128 bytes under the swizzle of that width. wgmma reads the same
// tile two ways (Layout<D> below):
//   * K-major, contracting over D (Q Kᵀ, K Qᵀ, V dOᵀ): rows 8 at a time
//     (SBO = 8 rows), a k step of 16 columns is +32 bytes inside a row, the
//     next box after BOX / 16 steps;
//   * MN-major, contracting over the rows (P V, Pᵀ dO, dSᵀ Q): a k step of
//     16 rows is +16 row lengths, the D columns run along N, the next box of
//     64 at LBO = the box's bytes.
// Every tile starts on 1024 bytes, so the swizzle's phase (the address
// bits it XORs) is the same for TMA's writes and wgmma's reads.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int WG = 128;  // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p moved up to the next 1024-byte boundary of shared memory
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and add `bytes` to the phase's expected transaction count
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed). A wait of 2^35 cycles (over
// 15 s) means an arrival or a copy was lost: the kernel traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// ------------------------------------------------------------------ TMA
// one box of a 3-D tensor map at (column, row, matrix) into shared memory,
// completing on `bar`; boxes past the tensor's edge are zero-filled
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// --------------------------------------------------------------- layouts
// A tile stored as boxes of [rows][ROW bytes] under the swizzle of width
// ROW: a K-major k step (16 bf16 or 8 tf32 columns) is +32 bytes inside a
// row, the next box after ROW / 32 steps. TF32 operands are read K-major
// only (wgmma has no transpose for 4-byte types).
template <int ROW>
struct KMajor {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "box row bytes");
  static constexpr uint64_t MODE = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int STEPS = ROW / 32;        // k steps of 32 bytes per box

  // the wgmma descriptor of a tile's rows [r0, r0 + 64) (or its whole
  // width for B), start address + offsets in 16-byte units
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
           static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | MODE << 62;
  }
  // K-major: contract over the columns; k step kk of a tile of `rows` rows
  __device__ static uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
    const uint32_t a = tile + (kk / STEPS) * rows * ROW + r0 * ROW + (kk % STEPS) * 32;
    return desc(a, 16, 8 * ROW);
  }
};

// a (rows, D) bf16 tile in boxes of BOX = min(D, 64) columns
template <int D>
struct Layout : KMajor<(D < 64 ? D : 64) * 2> {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int BOX = D < 64 ? D : 64;   // columns of one TMA box
  static constexpr int ROW = BOX * 2;           // bytes of a box row = the swizzle

  // MN-major: contract over the rows; k step kk (rows 16kk..16kk+15)
  __device__ static uint64_t mnmajor(uint32_t tile, int rows, int kk) {
    return KMajor<ROW>::desc(tile + kk * 16 * ROW, rows * ROW, 8 * ROW);
  }
};

// ----------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for register A operands, which the product reads until its wait
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
}

template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);

// d (+)= A B, m64nNk16, bf16 in, f32 accumulators; A and B both K-major in
// shared memory (acc = 0 overwrites d)
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B, m64nNk16, bf16 in, f32 accumulators; A from registers (the
// fragment of a_split), B MN-major in shared memory
template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ------------------------------------------------------- float32 tiles
// the 3×TF32 float32 kernels: tiles of 4-byte elements are KMajor<128>
// (32 floats a box row) or KMajor<64> (16), read K-major only
template <int N>
__device__ void mma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void mma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);

// d (+)= A B, m64nNk8, tf32 in, f32 accumulators; A and B K-major in
// shared memory (acc = 0 overwrites d)
template <>
__device__ __forceinline__ void mma_ss_tf32<8>(float (&d)[4], uint64_t a, uint64_t b,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<16>(float (&d)[8], uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B, m64nNk8, tf32 in, f32 accumulators; A from registers (one
// tf32 per register: rows g and g + 8 of the warp's 16, k columns t and
// t + 4, g = lane / 4, t = lane % 4, in the order (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)), B K-major in shared memory
template <>
__device__ __forceinline__ void mma_rs_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// x = big + small + e with big = tf32(x) and small = tf32(x - big), each
// rounded to nearest (ties away): |e| <= 2^-11 |x - big| <= 2^-22 |x|. The
// low 13 bits of both are 0, as wgmma's tf32 operands expect.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// the A fragment of k step kk (columns 8kk..8kk+7 of an m64nNk8 product's
// accumulator, in the permuted order of a transposed operand written by
// tf32_planes_vt) as two tf32 terms: a thread's accumulator holds columns
// 2t, 2t + 1 of each group of 8 where the A fragment wants t and t + 4
template <int NS>
__device__ __forceinline__ void tf32_frag(const float (&s)[NS], int kk, uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  tf32_split(s[4 * kk], big[0], small[0]);      // (g, column 2t)
  tf32_split(s[4 * kk + 2], big[1], small[1]);  // (g + 8, column 2t)
  tf32_split(s[4 * kk + 1], big[2], small[2]);  // (g, column 2t + 1)
  tf32_split(s[4 * kk + 3], big[3], small[3]);  // (g + 8, column 2t + 1)
}

// the pre-pass of the float32 kernels: n floats (n % 4 == 0) into their
// tf32 terms; block 0 also resets the item counter (if any) of the kernel
// that follows on the stream
__global__ void __launch_bounds__(256)
tf32_planes(const float4* __restrict__ x, uint4* __restrict__ big,
            uint4* __restrict__ small, long long n4, int* __restrict__ counter) {
  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += 256ll * gridDim.x) {
    const float4 v = x[i];
    uint4 b, s;
    tf32_split(v.x, b.x, s.x);
    tf32_split(v.y, b.y, s.y);
    tf32_split(v.z, b.z, s.z);
    tf32_split(v.w, b.w, s.w);
    big[i] = b;
    small[i] = s;
  }
}

// the pre-pass of an operand read transposed: (mats, s, d) into the terms
// of its transpose, (mats, d, sp) with sp a multiple of 32, the s axis
// permuted within groups of 8 (slot c of a group holds row 2c for c < 4,
// 2(c - 4) + 1 above), rows past s 0; with nbig (and nsmall) given, also
// into the terms of the operand as it is, from the same read; with centre
// given ((mats, d) floats), the transpose's rows (not those past s) are
// x - centre, the subtraction in float32 before the split. A block (32, 8)
// moves 32 rows × 32 (or d) columns through shared memory.
__global__ void __launch_bounds__(256)
tf32_planes_vt(const float* __restrict__ v, uint32_t* __restrict__ big,
               uint32_t* __restrict__ small, uint32_t* __restrict__ nbig,
               uint32_t* __restrict__ nsmall, const float* __restrict__ centre, int s,
               int sp, int d) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, d0 = blockIdx.y * 32, dt = min(32, d - d0);
  const long long mat = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int rr = ty; rr < 32; rr += 8) {
    const int row = c0 + rr;
    const long long at = (mat * s + row) * d + d0 + tx;
    const bool in = row < s && tx < dt;
    const float x = in ? v[at] : 0.f;
    tile[rr][tx] = x;
    if (nbig != nullptr && in) tf32_split(x, nbig[at], nsmall[at]);
  }
  __syncthreads();
  const int src = (tx & ~7) | ((tx & 7) < 4 ? 2 * (tx & 7) : 2 * (tx & 7) - 7);
  for (int dd = ty; dd < dt; dd += 8) {
    uint32_t b, sm;
    float x = tile[src][dd];
    if (centre != nullptr && c0 + src < s) x -= centre[mat * d + d0 + dd];
    tf32_split(x, b, sm);
    const long long at = (mat * d + d0 + dd) * sp + c0 + tx;
    big[at] = b;
    small[at] = sm;
  }
}

// both pre-passes on a stream: x (n floats) into dst (big) and dst + n
// (small); x as (mats, s, d) transposed into dst and dst + mats · d · sp
// (less centre, if given), and, with ndst given, as it is into ndst and
// ndst + mats · s · d
inline void planes(const float* x, float* dst, long long n, int* counter,
                   cudaStream_t stream) {
  const long long n4 = n / 4, blocks = (n4 + 255) / 256;
  tf32_planes<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint4*>(dst),
      reinterpret_cast<uint4*>(dst + n), n4, counter);
}
inline void planes_t(const float* x, float* dst, int mats, int s, int sp, int d,
                     cudaStream_t stream, float* ndst = nullptr,
                     const float* centre = nullptr) {
  const long long n = static_cast<long long>(mats) * s * d;
  tf32_planes_vt<<<dim3(sp / 32, (d + 31) / 32, mats), dim3(32, 8), 0, stream>>>(
      x, reinterpret_cast<uint32_t*>(dst),
      reinterpret_cast<uint32_t*>(dst + static_cast<long long>(mats) * d * sp),
      reinterpret_cast<uint32_t*>(ndst),
      ndst == nullptr ? nullptr : reinterpret_cast<uint32_t*>(ndst + n), centre, s, sp, d);
}

// rows [r0, r0 + 64) of a float32 tile of `rows` rows in NBOX boxes of
// ROW-byte rows, loaded raw into its big plane: split in place into the
// two tf32 terms, small at +plane bytes, by the 128 threads of one
// warpgroup (tid its thread). The swizzle moves 16-byte chunks within a
// row and both planes share it, so each chunk splits where it lies. The
// caller then syncs the warpgroup (wg_sync) before a wgmma reads the rows.
template <int NBOX, int ROW>
__device__ __forceinline__ void split_rows(uint8_t* tile, int plane, int rows, int r0,
                                           int tid) {
#pragma unroll
  for (int c = 0; c < NBOX; ++c) {
    uint8_t* at = tile + c * rows * ROW + r0 * ROW;
#pragma unroll 4
    for (int off = 16 * tid; off < 64 * ROW; off += 16 * WG) {
      const float4 x = *reinterpret_cast<const float4*>(at + off);
      uint4 b, s;
      tf32_split(x.x, b.x, s.x);
      tf32_split(x.y, b.y, s.y);
      tf32_split(x.z, b.z, s.z);
      tf32_split(x.w, b.w, s.w);
      *reinterpret_cast<uint4*>(at + off) = b;
      *reinterpret_cast<uint4*>(at + plane + off) = s;
    }
  }
}

// this thread's shared-memory writes made visible to wgmma (the async
// proxy), then a barrier of the 128 threads of warpgroup wg (named
// barrier 1 + wg; 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(WG) : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22; 2^0 = 1
// and 2^-inf = 0 exactly, subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) = hi + lo + e, each term a packed bf16 pair (x in the low half):
// hi is x and y with their low 16 bits dropped (bf16 rounded toward zero,
// a byte permutation), lo = bf16(x - hi) rounded to nearest (x - hi is
// exact in float32). |e| <= 2^-16 |x|: two bf16 terms hold a float32
// operand as closely as a rounded hi would, with one float-to-bf16
// conversion instead of two.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __uint_as_float(xb & 0xFFFF0000u),
                                                 y - __uint_as_float(yb & 0xFFFF0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A operand of a 16-deep k step from an m64nNk16 accumulator whose
// columns are that k: columns 16kk..16kk+15 are registers 8kk..8kk+7, in
// the order of the A fragment, split into two bf16 terms
template <int N>
__device__ __forceinline__ void a_split(const float (&c)[N], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1], hi[r], lo[r]);
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// once per kernel and device: opt the kernel in to `smem` bytes of dynamic
// shared memory and read the device's SM count into *sms (both cost host
// time on every call otherwise). Returns a cudaError_t.
template <auto Kernel>
inline int prepare(int smem, int* sms) {
  static int known[64] = {};  // per device: its SM count once prepared
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev < 64 && known[dev]) {
    *sms = known[dev];
    return 0;
  }
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!e) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e && dev < 64) known[dev] = *sms;
  return e;
}

// the tensor map of a contiguous (mats, s, d) array of bf16 (esize 2) or
// float32 (esize 4) read in boxes of [rows][cols] (cols = 0: min(d, 128 /
// esize)) with the swizzle of the box row's width; rows past s (and
// columns past d) read as 0 within their own matrix. Returns a cudaError_t.
inline int tile_map(CUtensorMap* map, const void* base, int mats, int s, int d, int rows,
                    int esize = 2, int cols = 0) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int box = cols > 0 ? cols : d < 128 / esize ? d : 128 / esize;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * esize,
                                 static_cast<cuuint64_t>(s) * d * esize};
  const cuuint32_t boxdim[3] = {static_cast<cuuint32_t>(box),
                                static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const int row = box * esize;
  const CUtensorMapSwizzle sw = row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(base),
                        dims, strides, boxdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace hopper
