// Shared pieces of the two quantized matmul kernels (w8a8_matmul.cu,
// w4a8_matmul.cu): the block size, masked loads of int8 words, the
// split-k block's reduction over its k-slices and meeting of the splits
// (splitk_finish), which W4A8 uses, and the tensor-core regimes' copies
// of operand tiles into shared memory (copy_tile).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace qmm {

constexpr int kThreads = 256;                      // threads a block

// The bytes p[0, valid) as a little-endian word, zero above; one aligned
// 32-bit load when vec and all four bytes are valid.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p,
                                         int valid, bool vec) {
  if (vec && valid >= 4) return *reinterpret_cast<const int*>(p);
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) word |= static_cast<unsigned>(static_cast<uint8_t>(p[j]))
                           << (8 * j);
  return static_cast<int>(word);
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// ----------------------------------------------------- split-k block
// 256 threads = 8 warps, one k-slice each; lane l owns columns
// 4 l .. 4 l + 3 of an MT x 128 output tile, so a warp's load reads a
// 128-byte line of a weight row.  The grid's third dimension splits k.
constexpr int kSplitLanes = 32;                    // column threads: a warp
constexpr int kSplitCols = 4 * kSplitLanes;        // 128 columns a block
constexpr int kSplitSlices = kThreads / kSplitLanes;

// A split-k block's end: acc summed over the 8 slices through shared
// memory, one output row at a time.  Unsplit (gridDim.z == 1) it writes
// out[row, col] = epi(sum, col).  Split, it adds the sums into `sums`
// ((m, n) int32) by atomics; the tile's last split to arrive, told by
// its counter in `counters`, writes epi of the totals and re-zeroes the
// tile's sums and its counter, so the workspace is zero again when the
// kernel ends.  Integer sums: the splits' order changes no bit.
template <int MT, class Epi>
__device__ __forceinline__ void splitk_finish(
    const int (&acc)[MT][4], float* __restrict__ out, int* __restrict__ sums,
    unsigned* __restrict__ counters, int m, int n, int row0, int col_base,
    const Epi& epi) {
  __shared__ int red[kSplitSlices][kSplitCols];    // one row's slice sums
  __shared__ bool last;
  const int lane = threadIdx.x % kSplitLanes;
  const int slice = threadIdx.x / kSplitLanes;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[slice][4 * lane + c] = acc[r][c];
    __syncthreads();
    const int row = row0 + r, c = col_base + threadIdx.x;
    if (threadIdx.x < kSplitCols && row < m && c < n) {
      int s = 0;
#pragma unroll
      for (int sl = 0; sl < kSplitSlices; ++sl) s += red[sl][threadIdx.x];
      if (gridDim.z == 1)
        out[static_cast<size_t>(row) * n + c] = epi(s, c);
      else
        atomicAdd(sums + static_cast<size_t>(row) * n + c, s);
    }
    __syncthreads();
  }
  if (gridDim.z == 1) return;

  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < MT * kSplitCols; o += kThreads) {
    const int row = row0 + o / kSplitCols, c = col_base + o % kSplitCols;
    if (row >= m || c >= n) continue;
    int* at = sums + static_cast<size_t>(row) * n + c;
    out[static_cast<size_t>(row) * n + c] = epi(__ldcg(at), c);
    *at = 0;
  }
  if (threadIdx.x == 0) *counter = 0;              // ready for the next call
}

// The split-k grid (columns, rows, splits) for splits of
// ceil(quads / splits) quads of 4 k; grid.z = 0 when a split would be
// empty, which the entry refuses.
inline dim3 splitk_grid(int m, int k, int n, int row_tile, int splits,
                        int* quads_per_split) {
  const int nq = (k + 3) / 4;
  *quads_per_split = (nq + splits - 1) / splits;
  const int z = (nq + *quads_per_split - 1) / *quads_per_split;
  return dim3((n + kSplitCols - 1) / kSplitCols,
              (m + row_tile - 1) / row_tile, z == splits ? splits : 0);
}


// ------------------------------------------- tensor-core operand tiles

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes at p, of which `valid` are inside the matrix (zero above)
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ p,
                                       int valid) {
  return make_int4(load_word(p, valid, false),
                   load_word(p + 4, valid - 4, false),
                   load_word(p + 8, valid - 8, false),
                   load_word(p + 12, valid - 12, false));
}

// Rows [row0, +kRows) x bytes [c0, +128) of a (rows, cols) int8 matrix
// as kRows * 8 chunks of 16 bytes, zero outside it; thread t copies
// chunks t + 256 j (row (t + 256 j) / 8, chunk t % 8 of the row) to byte
// 16 (t + 256 j) of the tile, swizzled or not.  kAsync: cp.async (cols %
// 16 == 0, 16-byte aligned base); else loads and stores, bytewise.
template <bool kAsync, int kRows = 128>
__device__ __forceinline__ void copy_tile(uint8_t* tile, bool swizzle,
                                          const int8_t* __restrict__ src,
                                          int rows, int cols, int row0,
                                          int c0) {
#pragma unroll
  for (int j = 0; j < kRows / 32; ++j) {
    const int i = threadIdx.x + 256 * j;
    const int row = row0 + i / 8, c = c0 + 16 * (i % 8);
    const uint32_t off = swizzle ? tc::swizzle128(i * 16) : i * 16;
    const bool in = row < rows && c < cols;
    const int8_t* p = src + static_cast<size_t>(in ? row : 0) * cols
                      + (in ? c : 0);
    if constexpr (kAsync) {
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(tile + off)),
                 p, in ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(tile + off) = load16(p, in ? cols - c : 0);
    }
  }
}

}  // namespace qmm

extern "C" const char* qappa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
