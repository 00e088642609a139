// W4A8-pow2 matmul for Hopper: (m, k) int8 activations x (k/2, n) int8
// weights holding two 4-bit power-of-two codes per byte -> f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w4a8_matmul.py
// (_w4a8_kernel with _decode_pow2_block, built around pl.pallas_call in
// w4a8_matmul).  Code layout as there: packed row p holds k = 2p in the
// low nibble and k = 2p + 1 in the high one; bit 3 is the sign and bits
// 0-2 the exponent e of the value +-2^(e - 7).  The TPU kernel decodes to
// float32 and sums in float32; this kernel sums the integers
// +-(x << e) exactly in int32 (the paper's LightPE-1 shift-add datapath:
// |sum| <= 128 * 128 * k < 2^31 for k < 2^17) and applies 2^-7 in the
// epilogue, out = ((float(acc) * 2^-7) * x_scale) * w_scale[n].  That is
// bit-identical to the plain version's exact float64 sum, and differs
// from the TPU kernel's float32 sum only by that sum's rounding.
//
// What bounds it on an H100: bytes, half those of W8A8 for the same
// shape.  Block shape and activation staging are those of qmatmul.cuh.
// A 256-entry table in shared memory turns a weight byte into its two
// signed 16-bit values +-2^e in one word, and __dp2a_lo / __dp2a_hi add
// two 16 x 8-bit products each into int32.  Ragged m, k and n are masked
// in the kernel.  No tensor cores, TMA or split-k yet.
#include "qmatmul.cuh"

namespace {

using namespace qmm;

// +-2^e of one 4-bit code, unscaled by the 2^-7 bias
__device__ __forceinline__ int pow2_value(int code) {
  const int v = 1 << (code & 7);
  return (code & 8) ? -v : v;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
w4a8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ wp,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int m, int k, int n, bool x_vec,
                   bool w_vec) {
  __shared__ Smem<MT> sm;
  __shared__ int lut[256];   // byte -> (low code's value | high's << 16)
  for (int b = threadIdx.x; b < 256; b += kThreads)
    lut[b] = static_cast<int>(
        (static_cast<unsigned>(pow2_value(b & 15)) & 0xffffu) |
        (static_cast<unsigned>(pow2_value(b >> 4)) << 16));

  const int slice = threadIdx.x / kColThreads;
  const int col_base = blockIdx.x * kCols;
  const int col = col_base + 4 * (threadIdx.x % kColThreads);
  const int row0 = blockIdx.y * MT;
  const int nq = (k + 3) / 4;
  const int kp = k / 2;

  int acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int q0 = 0; q0 < nq; q0 += kChunkQuads) {
    const int cq = min(kChunkQuads, nq - q0);
    __syncthreads();                               // table built, chunk consumed
    stage_x<MT>(sm.x, x, m, k, row0, q0, cq, x_vec);
    __syncthreads();
#pragma unroll 2
    for (int q = slice; q < cq; q += kSlices) {
      const int p = 2 * (q0 + q);                  // packed rows of k..k+3
      // a row past the end reads as code 0 (+1) but meets x == 0 there
      const int w0 = p < kp ? load_word(wp + static_cast<size_t>(p) * n + col,
                                        n - col, w_vec)
                            : 0;
      const int w1 = p + 1 < kp
                         ? load_word(wp + static_cast<size_t>(p + 1) * n + col,
                                     n - col, w_vec)
                         : 0;
      int lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = lut[(w0 >> (8 * c)) & 0xff];       // k = 4q, 4q + 1
        hi[c] = lut[(w1 >> (8 * c)) & 0xff];       // k = 4q + 2, 4q + 3
      }
      const int4* xv = reinterpret_cast<const int4*>(sm.x + q * MT);
#pragma unroll
      for (int r4 = 0; r4 < MT / 4; ++r4) {
        const int4 x4 = xv[r4];
        const int xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * r4 + i][c] = __dp2a_hi(
                hi[c], xr[i], __dp2a_lo(lo[c], xr[i], acc[4 * r4 + i][c]));
      }
    }
  }
  reduce_store<MT, true>(acc, sm, xs, ws, out, m, n, row0, col_base);
}

template <int MT>
int launch(const int8_t* x, const int8_t* wp, const float* xs,
           const float* ws, float* out, int m, int k, int n,
           cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + MT - 1) / MT);
  w4a8_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, wp, xs, ws, out, m, k, n, k % 4 == 0 && aligned4(x),
      n % 4 == 0 && aligned4(wp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) int8 with k even, w_packed (k/2, n) int8, x_scale (1,) f32,
// w_scale (n,) f32 and out (m, n) f32, all contiguous on the device;
// launches on `stream` and returns the CUDA error code of the launch.
extern "C" int qappa_w4a8_matmul(const void* x, const void* w_packed,
                                 const void* x_scale, const void* w_scale,
                                 void* out, int m, int k, int n,
                                 void* stream) {
  if (m < 1 || k < 2 || k % 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w_packed);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 4) return launch<4>(xq, wq, xs, ws, o, m, k, n, s);
  if (m <= 8) return launch<8>(xq, wq, xs, ws, o, m, k, n, s);
  return launch<16>(xq, wq, xs, ws, o, m, k, n, s);
}
