// W8A8 matmul for Hopper: (m, k) int8 x (k, n) int8 -> int32 -> f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w8a8_matmul.py
// (_w8a8_kernel, built around pl.pallas_call in w8a8_matmul) and computes
// the same function: an exact int32 sum over k, then
// out = (float(acc) * x_scale) * w_scale[n] in float32.
//
// What bounds it on an H100: bytes.  At the decode shape (m = 4) a
// weight byte feeds 4 multiply-adds, far below the ~600 int8 operations
// per byte at which the card stops being bound by its 3.35 TB/s, so the
// time is the weight matrix's bytes.  The TPU kernel's 128 x 128 tiles
// would waste 97 % of their rows at m = 4; here a block owns 32 columns
// of an MT-row tile (MT = 4, 8 or 16 by m) and 32 k-slices stream the
// weight rows with coalesced 32-bit loads (see qmatmul.cuh).  Each slice
// takes four k rows at a time, transposes the 4 x 4 bytes with
// __byte_perm so each column's four weights share a word, and __dp4a
// adds four products per instruction into int32.  The int32 sum is exact
// (|sum| < 2^31 for k < 2^17), so the result is bit-identical to the
// plain version's float64 product; ragged m, k and n are masked in the
// kernel, nothing is padded.  No tensor cores, TMA or split-k yet.
#include "qmatmul.cuh"

namespace {

using namespace qmm;

template <int MT>
__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int m, int k, int n, bool x_vec,
                   bool w_vec) {
  __shared__ Smem<MT> sm;
  const int slice = threadIdx.x / kColThreads;
  const int col_base = blockIdx.x * kCols;
  const int col = col_base + 4 * (threadIdx.x % kColThreads);
  const int row0 = blockIdx.y * MT;
  const int nq = (k + 3) / 4;

  int acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int q0 = 0; q0 < nq; q0 += kChunkQuads) {
    const int cq = min(kChunkQuads, nq - q0);
    __syncthreads();                               // last chunk consumed
    stage_x<MT>(sm.x, x, m, k, row0, q0, cq, x_vec);
    __syncthreads();
#pragma unroll 2
    for (int q = slice; q < cq; q += kSlices) {
      const int kk = 4 * (q0 + q);
      int rows[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rows[j] = kk + j < k
                      ? load_word(w + static_cast<size_t>(kk + j) * n + col,
                                  n - col, w_vec)
                      : 0;
      // 4 x 4 byte transpose: cols[c] = column col + c of rows kk..kk+3
      const int t0 = __byte_perm(rows[0], rows[1], 0x5140);
      const int t1 = __byte_perm(rows[0], rows[1], 0x7362);
      const int t2 = __byte_perm(rows[2], rows[3], 0x5140);
      const int t3 = __byte_perm(rows[2], rows[3], 0x7362);
      const int cols[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
      const int4* xv = reinterpret_cast<const int4*>(sm.x + q * MT);
#pragma unroll
      for (int r4 = 0; r4 < MT / 4; ++r4) {
        const int4 x4 = xv[r4];
        const int xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * r4 + i][c] = __dp4a(xr[i], cols[c], acc[4 * r4 + i][c]);
      }
    }
  }
  reduce_store<MT, false>(acc, sm, xs, ws, out, m, n, row0, col_base);
}

template <int MT>
int launch(const int8_t* x, const int8_t* w, const float* xs,
           const float* ws, float* out, int m, int k, int n,
           cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + MT - 1) / MT);
  w8a8_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, w, xs, ws, out, m, k, n, k % 4 == 0 && aligned4(x),
      n % 4 == 0 && aligned4(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) int8, w (k, n) int8, x_scale (1,) f32, w_scale (n,) f32 and
// out (m, n) f32, all contiguous on the device; launches on `stream`
// and returns the CUDA error code of the launch.
extern "C" int qappa_w8a8_matmul(const void* x, const void* w,
                                 const void* x_scale, const void* w_scale,
                                 void* out, int m, int k, int n,
                                 void* stream) {
  if (m < 1 || k < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 4) return launch<4>(xq, wq, xs, ws, o, m, k, n, s);
  if (m <= 8) return launch<8>(xq, wq, xs, ws, o, m, k, n, s);
  return launch<16>(xq, wq, xs, ws, o, m, k, n, s);
}
