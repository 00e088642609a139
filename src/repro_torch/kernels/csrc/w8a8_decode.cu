// W8A8 decode attention for Hopper: one GQA decode step over an int8 KV
// cache with per-(position, head) scales.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w8a8_decode.py (_kernel,
// built around pl.pallas_call in w8a8_decode_attention) from the point
// where q is quantized: the wrapper (kernels/w8a8_decode.py) hands over the
// q codes and one float32 logit factor per row, so the model's bf16 q
// quantization and the TPU kernel's float32 one share this body.
//
// What it computes, per (batch row b, kv head g), for rep query rows:
//   logit[r][s] = (float(q_q[r] . k_q[s]) * factor[r]) * k_scale[s],
//                 s <= pos[b] (later keys are masked: never read)
//   p = expf(logit - max_s logit);  l = sum_s p (float64, then float32)
//   pf = p * v_scale;  per block of bs keys: p_s = max pf / 127,
//   code = rint(pf / max(p_s, 1e-12));  acc += float(code . v_q) * p_s
//   out = acc / max(l, 1e-30)
// with both integer products exact in int32 (__dp4a).  The softmax uses
// the row's global maximum (two passes over the logits, kept in a float32
// scratch buffer the wrapper allocates), as the oracle
// ref.w8a8_decode_attention_ref does; the TPU kernel's running maximum
// differs only by rounding.  Built without fast-math, so expf and every
// division are the IEEE functions PyTorch's plain version calls.
//
// What bounds it on an H100: bytes.  K and V (int8) plus their float32
// scales are read once, ~34.6 MB a layer at b 4, S 4096, kvh 8, hd 128, a
// 10.3 us bound at 3.35 TB/s; its few int8 operations per byte are far
// below the card's ridge.  Keys past pos are skipped, so a short context
// reads only its own rows of the cache.
//
// Layout: one block of 256 threads per (b, g), as the TPU grid has it.  At
// b 4, kvh 8 that is 32 blocks on 132 SMs: a later design splits S across
// blocks.  Pass 1: a thread per key reads the key's hd bytes with 16-byte
// loads and dots them with the rep q rows (q codes broadcast from shared
// memory); logits go to scratch and a block reduction gives each row's
// maximum.  Pass 2, per block of bs keys: exp, v-scale, block maximum and
// the l partial sums (float64); then chunks of 512 keys: the codes are
// staged in shared memory, packed four keys to a word, and threads own
// (4-byte column word, key slice) pairs of V: four keys' V words are
// byte-transposed so each column's four values share a word, and one
// __dp4a adds four code x value products.  Slices meet through shared
// int32 atomics (exact, order-free), and the thread that owns an output
// element adds float(oi) * p_s to it block after block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;      // keys whose codes are staged at once
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

template <int R>
struct Smem {
  int qw[R][kMaxHd / 4];          // q codes, 4 to a word
  int codes[R][kChunk / 4];       // probability codes, 4 keys to a word
  int oi[R][kMaxHd];              // int32 PV of the current block
  float acc[R][kMaxHd];           // sum over blocks of float(oi) * p_s
  float red[R][kWarps];
  double lred[R][kWarps];
  float fac[R];
  float m[R];
  float ps[R];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// max over the block of v[r] for each row; result in out[r] (shared)
template <int R>
__device__ void block_max(float (&v)[R], float (&red)[R][kWarps],
                          float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float w = warp_max(v[r]);
    if (lane == 0) red[r][warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float x = red[threadIdx.x][0];
    for (int i = 1; i < kWarps; ++i) x = fmaxf(x, red[threadIdx.x][i]);
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
w8a8_decode_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ factor,
                   const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ pos, float* __restrict__ scratch,
                   void* __restrict__ out, int out_bf16, int kvh, int rep,
                   int hd, int S, int bs, bool vec16) {
  __shared__ Smem<R> sm;
  const int bg = blockIdx.x;
  const int b = bg / kvh, g = bg % kvh;
  const int tid = threadIdx.x;
  const int words = hd / 4;
  const int p = pos[b];
  const int n_live = p < 0 ? 0 : min(p, S - 1) + 1;   // keys 0..n_live-1
  float* sc = scratch + static_cast<size_t>(bg) * rep * S;

  for (int i = tid; i < R * (kMaxHd / 4); i += kThreads) {
    const int r = i / (kMaxHd / 4), w = i % (kMaxHd / 4);
    sm.qw[r][w] = (r < rep && w < words)
        ? reinterpret_cast<const int*>(q + (static_cast<size_t>(bg) * rep
                                            + r) * hd)[w]
        : 0;
  }
  for (int i = tid; i < R * kMaxHd; i += kThreads) {
    sm.acc[i / kMaxHd][i % kMaxHd] = 0.f;
    sm.oi[i / kMaxHd][i % kMaxHd] = 0;
  }
  if (tid < R) sm.fac[tid] = tid < rep ? factor[bg * rep + tid] : 0.f;
  __syncthreads();

  // ---- pass 1: logits of the live keys and each row's maximum ---------
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = kNegInf;
  for (int s = tid; s < n_live; s += kThreads) {
    const size_t row = (static_cast<size_t>(b) * S + s) * kvh + g;
    const int8_t* kr = k + row * hd;
    int a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = 0;
    if (vec16) {
#pragma unroll 8
      for (int w4 = 0; w4 < hd / 16; ++w4) {
        const int4 kv = reinterpret_cast<const int4*>(kr)[w4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = __dp4a(kv.x, sm.qw[r][4 * w4], a[r]);
          a[r] = __dp4a(kv.y, sm.qw[r][4 * w4 + 1], a[r]);
          a[r] = __dp4a(kv.z, sm.qw[r][4 * w4 + 2], a[r]);
          a[r] = __dp4a(kv.w, sm.qw[r][4 * w4 + 3], a[r]);
        }
      }
    } else {
      for (int w = 0; w < words; ++w) {
        const int kw = reinterpret_cast<const int*>(kr)[w];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = __dp4a(kw, sm.qw[r][w], a[r]);
      }
    }
    const float ksv = ks[row];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        const float lg = (static_cast<float>(a[r]) * sm.fac[r]) * ksv;
        sc[static_cast<size_t>(r) * S + s] = lg;
        mx[r] = fmaxf(mx[r], lg);
      }
    }
  }
  block_max<R>(mx, sm.red, sm.m);

  // ---- pass 2: per block of bs keys -----------------------------------
  double lsum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lsum[r] = 0.0;
  const int slices = kThreads / words;
  const int col_word = tid % words, slice = tid / words;
  for (int s0 = 0; s0 < n_live; s0 += bs) {
    const int s1 = min(s0 + bs, n_live);
    float pm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pm[r] = 0.f;
    for (int s = s0 + tid; s < s1; s += kThreads) {
      const float vsv = vs[(static_cast<size_t>(b) * S + s) * kvh + g];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) {
          float* e = sc + static_cast<size_t>(r) * S + s;
          const float pv = expf(*e - sm.m[r]);
          lsum[r] += static_cast<double>(pv);
          const float pf = pv * vsv;
          *e = pf;
          pm[r] = fmaxf(pm[r], fabsf(pf));
        }
      }
    }
    block_max<R>(pm, sm.red, sm.ps);
    if (tid < R) sm.ps[tid] = sm.ps[tid] / 127.0f;
    __syncthreads();

    int a[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = 0;
    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int n = min(kChunk, s1 - c0);
      int8_t* cb = reinterpret_cast<int8_t*>(&sm.codes[0][0]);
      for (int i = tid; i < R * kChunk; i += kThreads) {
        const int r = i / kChunk, t = i % kChunk;
        float code = 0.f;
        if (r < rep && t < n)
          code = rintf(sc[static_cast<size_t>(r) * S + c0 + t]
                       / fmaxf(sm.ps[r], 1e-12f));
        cb[i] = static_cast<int8_t>(code);
      }
      __syncthreads();
      if (slice < slices) {
        const int nq = (n + 3) / 4;
#pragma unroll 4
        for (int qd = slice; qd < nq; qd += slices) {
          const int s = c0 + 4 * qd;
          int rows[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rows[j] = s + j < s1
                ? reinterpret_cast<const int*>(
                      v + ((static_cast<size_t>(b) * S + s + j) * kvh + g)
                              * hd)[col_word]
                : 0;
          // 4 x 4 byte transpose: cols[c] = value c of the word, keys s..s+3
          const int t0 = __byte_perm(rows[0], rows[1], 0x5140);
          const int t1 = __byte_perm(rows[0], rows[1], 0x7362);
          const int t2 = __byte_perm(rows[2], rows[3], 0x5140);
          const int t3 = __byte_perm(rows[2], rows[3], 0x7362);
          const int cols[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int cw = sm.codes[r][qd];
#pragma unroll
            for (int c = 0; c < 4; ++c) a[r][c] = __dp4a(cw, cols[c], a[r][c]);
          }
        }
      }
      __syncthreads();          // codes consumed before the next chunk
    }
    if (slice < slices) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rep)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            atomicAdd(&sm.oi[r][4 * col_word + c], a[r][c]);
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      sm.acc[r][d] = sm.acc[r][d]
          + static_cast<float>(sm.oi[r][d]) * sm.ps[r];
      sm.oi[r][d] = 0;
    }
    __syncthreads();
  }

  // ---- l, then out = acc / max(l, 1e-30) ------------------------------
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double w = warp_sum(lsum[r]);
    if (lane == 0) sm.lred[r][warp] = w;
  }
  __syncthreads();
  if (tid < R) {
    double x = 0.0;
    for (int i = 0; i < kWarps; ++i) x += sm.lred[tid][i];
    sm.m[tid] = fmaxf(static_cast<float>(x), 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const float o = sm.acc[r][d] / sm.m[r];
    const size_t at = (static_cast<size_t>(bg) * rep + r) * hd + d;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(out)[at] = o;
  }
}

template <int R>
int launch(const int8_t* q, const float* f, const int8_t* k, const int8_t* v,
           const float* ks, const float* vs, const int* pos, float* scratch,
           void* out, int out_bf16, int b, int kvh, int rep, int hd, int S,
           int bs, cudaStream_t stream) {
  // 16-byte loads of K rows when every row starts on a 16-byte boundary
  const bool vec16 = hd % 16 == 0
      && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  w8a8_decode_kernel<R><<<b * kvh, kThreads, 0, stream>>>(
      q, f, k, v, ks, vs, pos, scratch, out, out_bf16, kvh, rep, hd, S, bs,
      vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, kvh, rep, hd) int8 codes, factor (b, kvh, rep) f32, k/v (b, S, kvh,
// hd) int8, k_scale/v_scale (b, S, kvh) f32, pos (b,) int32, scratch
// (b * kvh, rep, S) f32 and out (b, kvh, rep, hd) f32 or bf16, all
// contiguous on the device; launches on `stream` and returns the CUDA
// error code of the launch.
extern "C" int qappa_w8a8_decode(const void* q, const void* factor,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* pos, void* scratch, void* out,
                                 int out_bf16, int b, int kvh, int rep,
                                 int hd, int S, int bs, void* stream) {
  if (b < 1 || kvh < 1 || rep < 1 || rep > 16 || hd < 4 || hd % 4
      || hd > kMaxHd || S < 1 || bs < 1 || S % bs
      || static_cast<long long>(bs) * 127 * 127 >= (1LL << 31)
      || reinterpret_cast<uintptr_t>(q) % 4 || reinterpret_cast<uintptr_t>(k) % 4
      || reinterpret_cast<uintptr_t>(v) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* f = static_cast<const float*>(factor);
  const auto* kq = static_cast<const int8_t*>(k);
  const auto* vq = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* p = static_cast<const int*>(pos);
  auto* sc = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (rep <= 1)
    return launch<1>(qq, f, kq, vq, ksp, vsp, p, sc, out, out_bf16, b, kvh,
                     rep, hd, S, bs, s);
  if (rep <= 2)
    return launch<2>(qq, f, kq, vq, ksp, vsp, p, sc, out, out_bf16, b, kvh,
                     rep, hd, S, bs, s);
  if (rep <= 4)
    return launch<4>(qq, f, kq, vq, ksp, vsp, p, sc, out, out_bf16, b, kvh,
                     rep, hd, S, bs, s);
  if (rep <= 8)
    return launch<8>(qq, f, kq, vq, ksp, vsp, p, sc, out, out_bf16, b, kvh,
                     rep, hd, S, bs, s);
  return launch<16>(qq, f, kq, vq, ksp, vsp, p, sc, out, out_bf16, b, kvh,
                    rep, hd, S, bs, s);
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
