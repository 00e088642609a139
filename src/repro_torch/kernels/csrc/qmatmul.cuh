// Shared pieces of the two quantized matmul kernels (w8a8_matmul.cu,
// w4a8_matmul.cu): block shape, staging of the int8 activations in shared
// memory, the reduction over k-slices and the dequantizing epilogue.
//
// Block shape: 256 threads own 32 output columns of an MT-row tile
// (MT = 4, 8 or 16).  Thread t is column thread t % 8 (4 adjacent
// columns, so one 32-bit load reads a weight row's 4 bytes) of k-slice
// t / 8; the 32 k-slices stride over the k axis four k at a time, so a
// weight row segment of 32 bytes is read by 8 neighbouring lanes.  Each
// thread keeps MT x 4 int32 sums in registers; the slices are summed by
// warp shuffles and then through shared memory.  The activations of the
// tile are staged in shared memory 1024 k at a time as int32 words
// [k/4][row], so the 4 k-bytes of MT rows arrive in MT/4 vector loads.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qmm {

constexpr int kColThreads = 8;                     // threads along n
constexpr int kCols = 4 * kColThreads;             // columns per block
constexpr int kSlices = 32;                        // k-slices per block
constexpr int kThreads = kColThreads * kSlices;    // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunkQuads = 256;                   // 1024 k per stage

template <int MT>
struct Smem {
  alignas(16) int x[kChunkQuads * MT];             // [k/4][row]
  int red[kWarps][kColThreads][MT * 4];            // per-warp sums
};

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

// x[row0 : row0 + MT, 4 q0 : 4 (q0 + cq)] into xs[q][r], zero outside x.
template <int MT>
__device__ __forceinline__ void stage_x(int* xs, const int8_t* __restrict__ x,
                                        int m, int k, int row0, int q0,
                                        int cq, bool x_vec) {
  for (int i = threadIdx.x; i < cq * MT; i += kThreads) {
    const int r = i / cq, q = i - r * cq;          // row-major: coalesced
    const int row = row0 + r, kk = 4 * (q0 + q);
    xs[q * MT + r] =
        row < m ? load_word(x + static_cast<size_t>(row) * k + kk, k - kk,
                            x_vec)
                : 0;
  }
}

// Sum acc over the block's 32 k-slices and write
// out[row, col] = ((float(sum) [* 2^-7]) * x_scale) * w_scale[col],
// each product rounded once, in the reference's order.
template <int MT, bool kPow2>
__device__ __forceinline__ void reduce_store(
    int (&acc)[MT][4], Smem<MT>& sm, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ out, int m, int n,
    int row0, int col_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & (kColThreads - 1);
#pragma unroll
  for (int r = 0; r < MT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);     // the warp's 4 slices
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kColThreads) sm.red[warp][ct][r * 4 + c] = v;
    }
  }
  __syncthreads();
  const float x_scale = xs[0];
  for (int o = threadIdx.x; o < MT * kCols; o += kThreads) {
    const int r = o / kCols, cc = o - r * kCols;
    const int row = row0 + r, col = col_base + cc;
    if (row >= m || col >= n) continue;
    int s = 0;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += sm.red[wv][cc >> 2][r * 4 + (cc & 3)];
    float v = __int2float_rn(s);
    if (kPow2) v = __fmul_rn(v, 0.0078125f);       // 2^-POW2_EXP_BIAS
    out[static_cast<size_t>(row) * n + col] =
        __fmul_rn(__fmul_rn(v, x_scale), ws[col]);
  }
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

}  // namespace qmm

extern "C" const char* qappa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
