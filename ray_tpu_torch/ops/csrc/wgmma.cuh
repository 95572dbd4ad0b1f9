// Hopper (sm_90a) building blocks of the tensor-core attention kernels (the
// int8 matmul borrows the cp.async copies and the bf16 packing):
// 16-byte cp.async copies into shared memory laid out in the 128-byte swizzle
// that wgmma descriptors read, the descriptors themselves, and the
// wgmma.mma_async products in raw PTX (no CUTLASS: a build stays seconds).
//
// Shared-memory tile layout ("swizzled tile"): a [R rows][C] bf16 matrix,
// C a multiple of 64, is stored as C / 64 sub-tiles of [R][64] (128 bytes a
// row), one after the other; in a sub-tile row r sits at r * 128 and its
// 16-byte chunk j at chunk position j ^ (r % 8). Every tile starts on a
// 1024-byte boundary, so the swizzle (address bits [4:6] ^= [7:9]) the
// hardware applies when it reads agrees with the one the copies wrote.
//
// The same tile serves two operand forms:
//   * K-major (the contracted index along a row, e.g. K[keys][D] in Q.K^T):
//     descriptor at sub-tile (k / 64) + (k % 64) * 2 bytes, SBO = 1024 (the
//     next 8 rows), LBO unused;
//   * MN-major (the contracted index down the rows, e.g. V[keys][D] in P.V,
//     "transposed B"): descriptor at row k * 128 bytes, SBO = 1024 (the next
//     8 contracted rows), LBO = the sub-tile size (the next 64 output
//     columns).
//
// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, register
// i < N / 2: row (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// (i / 4) * 8 + (t % 4) * 2 + i % 2. Registers 8c .. 8c + 7 of a product
// are, as bf16 pairs, exactly the register A operand of columns 16c .. 16c
// + 15 of a following product (the FlashAttention-3 arrangement).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rtt {
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the calling thread's shared-memory writes (cp.async included) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + R) of a row-major [n][C] bf16 matrix into a swizzled tile
// at dst; rows >= n are zero. NT threads share the copies.
template <int R, int C, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int n) {
  constexpr int kChunks = C / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n;
    const __nv_bfloat16* g = src + (in ? static_cast<int64_t>(r0 + r) * C + c * 8 : 0);
    cp_async_16(dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r & 7)) << 4), g, in ? 16 : 0);
  }
}

// R f32 values [r0, r0 + R) of a vector of n into shared memory; past n zero
template <int R, int NT>
__device__ __forceinline__ void load_vec(uint32_t dst, const float* __restrict__ src, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool in = r0 + i < n;
    cp_async_4(dst + 4 * i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// K-major operand: contracted columns [16 kk, 16 kk + 16) of a swizzled tile
// of R rows at tile, starting at its row `row` (a multiple of 8)
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row, int kk) {
  return desc(tile + (kk / 4) * (R * 128) + row * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major operand: contracted rows [16 kk, 16 kk + 16) of a swizzled tile of
// R rows at tile, all of its columns
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an in-flight wgmma reads or writes must not be touched, or
// reused, until its wgmma_wait: pinning them after the wait keeps the
// compiler from moving accesses above it or reallocating them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, which no softmax weight of a bf16 product can tell apart)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pair (lo, hi) as one 32-bit register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the A operand of contraction step c (16 columns) from a [64 x N]
// accumulator (see the layout note above)
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[c][j] = pack_bf16(d[8 * c + 2 * j], d[8 * c + 2 * j + 1]);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (the accumulator
// layout of a previous product, as bf16 pairs), B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers (the accumulator
// layout of a previous product, as bf16 pairs), B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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

// D[64 x N] (+)= A . B over 16 contracted rows, A in registers, B MN-major
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  if constexpr (N == 64) wgmma_rs_n64_tb(d, a, b, acc);
  else wgmma_rs_n128_tb(d, a, b, acc);
}

}  // namespace tc
}  // namespace rtt
