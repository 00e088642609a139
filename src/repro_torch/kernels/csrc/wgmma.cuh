// Hopper tensor-core building blocks shared by the kernels that use them
// (flash_attention_tc.cu, w8a8_matmul.cu, w4a8_matmul.cu): shared-memory matrix
// descriptors for the 128-byte swizzle, the warpgroup fences, and the
// asynchronous warpgroup products (wgmma.mma_async) at the shapes those
// kernels issue.  sm_90a only.
//
// Shared-memory layout (the B128 canonical form): an operand tile is
// stored as 128-byte rows; the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of that row, and eight rows make a 1024-byte atom, so a
// tile's base must be 1024-byte aligned.  A K-major operand keeps 128
// bytes of k in a row (64 bf16 or 128 int8); a wider k is stored as
// column blocks of 128 bytes one after the other.  An MN-major operand
// (bf16 only) keeps 64 values of m or n in a row, one row per k.
//
// Descriptor fields (PTX ISA, "Matrix Descriptor Format"): start address
// >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride byte
// offset >> 4 in 32-45, layout type in 62-63 (1 = 128-byte swizzle).
// Every product here spans one 128-byte column block of each operand, so
// the only step a descriptor needs is the 1024 bytes between atoms (8
// rows along m or n of a K-major operand, 8 k rows of an MN-major one);
// it goes into both offset fields, whichever of them the layout reads.
// A k step inside a 128-byte row moves the start address (the swizzle
// is applied to the absolute address bits, so the tile base must be
// 1024-byte aligned).
#pragma once

#include <cstdint>

namespace tc {

// 128-byte swizzle of byte offset `off` inside a tile of 128-byte rows
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

__device__ __forceinline__ uint64_t desc_b128(const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  constexpr uint64_t kAtom = 1024 >> 4;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) | (kAtom << 16)
         | (kAtom << 32) | (1ull << 62);
}

// generic-proxy shared-memory writes (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; each writer runs it
// before the barrier that precedes the product
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Accumulator layout of every product below (per warpgroup, m = 64):
// warp w of the group owns rows 16 w .. 16 w + 15; lane l holds, for
// j = 0 .. N/8 - 1, d[4j], d[4j+1] at row 16 w + l / 4, columns
// 8 j + 2 (l % 4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.  The
// register A operand of a k16 bf16 product has the same layout over its
// 16 columns, packed two bf16 to a register: a[0] row l / 4, columns
// 2 (l % 4) + {0, 1}; a[1] eight rows below; a[2], a[3] the same at
// columns + 8.

// D(64x64 f32) (+)= A(64x16 bf16, K-major smem) B(16x64 bf16, K-major smem)
__device__ __forceinline__ void wgmma_ss_bf16_n64(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x64 f32) (+)= A(64x16 bf16, registers) B(16x64 bf16, MN-major smem)
__device__ __forceinline__ void wgmma_rs_bf16_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The 64 s32 accumulators of an m64n128 integer product as asm operands
// %0 .. %63, and the register list that names them.
#define QAPPA_WGMMA_D64_LIST                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                              \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                              \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                              \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                              \
  " %56, %57, %58, %59, %60, %61, %62, %63}"
#define QAPPA_WGMMA_D64_OUT(d)                                            \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),             \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),             \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),        \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),        \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),        \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),        \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),        \
  "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),        \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),        \
  "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),        \
  "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),        \
  "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),        \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// D(64x128 s32) (+)= A(64x32 s8, K-major smem) B(32x128 s8, K-major smem)
__device__ __forceinline__ void wgmma_ss_s8_n128(
    int (&d)[64], uint64_t desc_a, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      QAPPA_WGMMA_D64_LIST ", %64, %65, p;\n}\n"
      : QAPPA_WGMMA_D64_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x128 s32) (+)= A(64x32 s8, K-major smem) B(32x128 u8, K-major smem)
__device__ __forceinline__ void wgmma_ss_s8u8_n128(
    int (&d)[64], uint64_t desc_a, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      QAPPA_WGMMA_D64_LIST ", %64, %65, p;\n}\n"
      : QAPPA_WGMMA_D64_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x128 s32) (+)= A(64x32 s8, registers) B(32x128 u8, K-major smem).
// The A fragment is the k16 bf16 one above in bytes: a[0] holds bytes
// 4 (l % 4) .. + 3 of row l / 4 of the warp's 16, a[1] eight rows below,
// a[2] and a[3] the same 16 bytes further along k.
__device__ __forceinline__ void wgmma_rs_s8u8_n128(
    int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      QAPPA_WGMMA_D64_LIST ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : QAPPA_WGMMA_D64_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

#undef QAPPA_WGMMA_D64_LIST
#undef QAPPA_WGMMA_D64_OUT

}  // namespace tc
