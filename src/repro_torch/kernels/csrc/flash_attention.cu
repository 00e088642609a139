// Flash attention forward for Hopper, float32 operands: tiled
// online-softmax attention on the CUDA cores.  bf16 operands go to the
// tensor-core kernel, flash_attention_tc.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, built around pl.pallas_call in flash_attention) and
// computes the same function: q, k, v (b*h, s, d) float32;
// logits = (q . k) * scale, masked to -1e30 where a key is in the
// future (causal) or outside the window (ki <= qi - window), the last q row
// aligned to the last key (qi = i + sk - sq); running max m, l = l * alpha
// + sum p, acc = acc * alpha + p . v; out = acc / max(l, 1e-30).
// Tiles wholly in the future or wholly outside the window are
// skipped, as the TPU kernel skips them.  Unlike it, any sq and sk are
// taken: keys past sk get p = 0 and rows past sq are not stored.
//
// What bounds it on an H100: operations.  At (1, 24, 4096, 128), causal,
// it does ~1.03e11 FLOP against ~200 MB of bytes.  It multiplies in
// float32 on the CUDA cores (explicit fmaf: the library builds with
// -fmad=false), so its ceiling is the 67 TFLOP/s float32 rate.  The
// tensor cores would round the operands to TF32 (~1e-3), outside the
// float32 bound of 1e-5, so float32 stays here.
//
// Layout: one block of 256 threads per (b*h, 64-row q tile).  Q, a 64-key
// K tile and V tile are staged in shared memory (K and Q rows
// padded by one float against bank conflicts); a thread owns 4 q rows x 4
// keys of the logit tile (keys tx + 16 j) and 4 rows x d/16 columns of the
// output (columns tx + 16 j).  Row max and row sum meet across the 16
// threads of a row group by warp shuffles; the probabilities go through
// shared memory to the PV product.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D
                          + kBQ * (kBK + 1));
}

__device__ __forceinline__ float group_max(float v) {   // 16 lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int sq,
             int sk, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);          // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);          // [kBK][D]
  float* Ps = Vs + kBK * D;                // [kBQ][kBK + 1]
  constexpr int NC = D / 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // global row index of tile row 0 (the last q row aligns to the last key)
  const long long q_off = static_cast<long long>(q0) + sk - sq;
  const size_t qbase = static_cast<size_t>(bh) * sq * D;
  const size_t kbase = static_cast<size_t>(bh) * sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] = q0 + r < sq
        ? q[qbase + static_cast<size_t>(q0 + r) * D + c] : 0.f;
  }
  float o[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
  }

  const int n_kt = (sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_off = kt * kBK;
    // whole-tile skips: strictly in the future (and so are later tiles),
    // or wholly outside every row's window
    if (causal && k_off > q_off + kBQ - 1) break;
    if (window > 0 && static_cast<long long>(k_off) + kBK - 1
                          <= q_off - window)
      continue;
    __syncthreads();            // the last tile's K, V, P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k_off + r < sk;
      const size_t at = kbase + static_cast<size_t>(k_off + r) * D + c;
      Ks[r * (D + 1) + c] = in ? k[at] : 0.f;
      Vs[r * D + c] = in ? v[at] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q_off + ty * 4 + i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long ki = k_off + tx + 16 * j;
        // keys past sk are out of the max here and get p = 0 below
        const bool keep = ki < sk && (!causal || ki <= qi)
            && (window <= 0 || ki > qi - window);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = k_off + key < sk ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (kBK + 1) + key] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = Vs[key * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float val = o[i][j] / den;
      const size_t at = qbase + static_cast<size_t>(row) * D + tx + 16 * j;
      out[at] = val;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int sq, int sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, sq, sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* q, const float* k, const float* v, float* out,
             int bh, int sq, int sk, int d, int causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<16>(q, k, v, out, bh, sq, sk, causal, window, scale, s);
    case 32:
      return launch<32>(q, k, v, out, bh, sq, sk, causal, window, scale, s);
    case 64:
      return launch<64>(q, k, v, out, bh, sq, sk, causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, out, bh, sq, sk, causal, window, scale, s);
    case 256:
      return launch<256>(q, k, v, out, bh, sq, sk, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), all contiguous
// float32 on the device; window 0 means none; launches on `stream` and
// returns the CUDA error code of the launch.
extern "C" int qappa_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int sq, int sk, int d, int causal,
                                     int window, float scale, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || window < 0
      || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out), bh,
                  sq, sk, d, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
