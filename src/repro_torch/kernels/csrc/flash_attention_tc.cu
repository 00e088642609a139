// Flash attention forward for Hopper on the bf16 tensor cores (wgmma).
//
// Replaces, for bf16 operands, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (_flash_kernel, built around
// pl.pallas_call in flash_attention); flash_attention.cu keeps float32.
// Same function as there and as flash_attention.cu: q, k, v (b*h, s, d)
// bf16; logits = (q . k) * scale in float32, masked to -1e30 where a key
// is in the future (causal) or outside the window (ki <= qi - window),
// the last q row aligned to the last key (qi = i + sk - sq); online
// softmax, out = acc / max(l, 1e-30) in bf16.  Tiles wholly in the
// future or wholly outside every row's window are skipped; keys past sk
// get p = 0 and stay out of the row max; rows past sq are not stored.
// One difference in rounding: the tensor cores take P in bf16, so P is
// split into two bf16 parts (hi and the rest, ~16 bits together) for
// two PV products, and l sums those parts.  One bf16 part alone moves
// the output by a bf16 ulp often enough that at |out| >= 4 (ulp 2^-5)
// it broke the bf16 bound of 2e-2 on a layer of the 1 x 4096 phi4
// forward.  The softmax runs in base 2 (2^x of logits scaled by
// scale * log2(e), the scaling fused into 2^x's argument).
//
// What bounds it on an H100: operations.  At (1, 24, 4096, 128), causal,
// ~1.03e11 FLOP against ~100 MB: 0.104 ms at the 989 TFLOP/s bf16 peak.
// Both products run on the tensor cores as asynchronous warpgroup
// products (wgmma.cuh): S = Q K^T with Q and K from shared memory
// (K-major), O += P V with P in registers (the S accumulator's layout is
// the A operand's) and V from shared memory (MN-major, transposed by the
// instruction).
//
// Layout: one block of 256 threads (two warpgroups of 64 q rows) per
// (b*h, 128-row q tile); the causal tiles are launched heaviest first.
// Q stays in shared memory; 64-key K and V tiles stream through two
// stages filled by 16-byte cp.async with the 128-byte swizzle, the next
// tile loading while the current one is multiplied.  Head dims below 64
// are zero-padded to 64 in shared memory (the padded columns add 0 to
// the logits and are not stored), so every d in {16, 32, 64, 128, 256}
// takes this kernel: d 256 keeps 32 + 128 + 16 accumulator and operand
// registers a thread and 193 KB of shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;      // q rows per block, 64 per warpgroup
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dims {
  static constexpr int DP = D < 64 ? 64 : D;   // d padded to 64-wide blocks
  static constexpr int NB = DP / 64;           // 128-byte column blocks
  static constexpr int Q_BYTES = kBQ * DP * 2;
  static constexpr int KV_BYTES = kBK * DP * 2;
  // Q, two stages of K and V, and slack to align the base to 1024
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

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

// rows [row0, row0 + R) of a (rows, D) bf16 matrix into a swizzled tile
// of NB column blocks [R][128 B]; rows past `rows` and columns past D
// are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int kChunks = Dims<D>::DP / 8;     // 16-byte chunks a row
  static_assert(R * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int j = 0; j < R * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < rows && c * 8 < D;
    const __nv_bfloat16* p =
        ok ? src + static_cast<size_t>(row0 + r) * D + c * 8 : src;
    const uint32_t off = (c / 8) * (R * 128) + r * 128 + (c % 8) * 16;
    cp_async16(tile + tc::swizzle128(off), p, ok ? 16 : 0);
  }
}

// 2^x by the SFU (relative error ~2^-22, far inside P's bf16 rounding);
// 2^-1e30 is 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);      // .x in the low half
}

// two blocks an SM up to d 128 (at most 128 registers a thread, 97 KB of
// shared memory each), so one block's softmax overlaps the other's
// products; one at d 256
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int sq, int sk, int causal,
                int window, float scale) {
  using S = Dims<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* Qs = smem;
  // stage st: K at Ks(st), V right after it
  auto Ks = [&](int st) { return smem + S::Q_BYTES + st * 2 * S::KV_BYTES; };
  auto sh = [](const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  // rows of this thread inside the block's tile: r, r + 8
  const int row_a = wg * 64 + warp * 16 + lane / 4;
  const long long q_off = static_cast<long long>(q0) + sk - sq;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * D;
  const float scale2 = scale * kLog2e;

  // the key tiles some row of the block needs
  const int n_kt = (sk + kBK - 1) / kBK;
  int kt_end = n_kt, kt_begin = 0;
  if (causal) {
    const long long last = q_off + kBQ - 1;        // the last row's key
    if (last < static_cast<long long>(n_kt) * kBK)
      kt_end = last < 0 ? 0 : static_cast<int>(last / kBK + 1);
  }
  if (window > 0) {
    const long long first = q_off - window + 1;   // row 0's first live key
    if (first > 0)
      kt_begin = first >= sk ? n_kt : static_cast<int>(first / kBK);
  }

  load_tile<D, kBQ>(sh(Qs), qb, q0, sq);
  if (kt_begin < kt_end) {
    load_tile<D, kBK>(sh(Ks(0)), kb, kt_begin * kBK, sk);
    load_tile<D, kBK>(sh(Ks(0) + S::KV_BYTES), vb, kt_begin * kBK, sk);
  }
  cp_async_commit();

  float o[S::NB][32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int b = 0; b < S::NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_tile<D, kBK>(sh(Ks(st ^ 1)), kb, (kt + 1) * kBK, sk);
      load_tile<D, kBK>(sh(Ks(st ^ 1) + S::KV_BYTES), vb, (kt + 1) * kBK,
                        sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();

    // S = Q K^T: d / 16 products of k16 over the column blocks
    float s[32];
    tc::fence_regs(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::DP / 16; ++kk) {
      const int b = kk / 4, w = kk % 4;
      tc::wgmma_ss_bf16_n64(
          s, tc::desc_b128(Qs + b * kBQ * 128 + wg * 64 * 128 + w * 32),
          tc::desc_b128(Ks(st) + b * kBK * 128 + w * 32), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);

    // mask, row max over the quad of lanes that share a row, online
    // rescale; element i sits at row row_a + 8 * ((i >> 1) & 1), key
    // k_off + 8 * (i / 4) + 2 * (lane % 4) + (i & 1).  Logits stay
    // unscaled here (the scale is > 0, so the max commutes with it);
    // 2^x takes fma(s, scale2, -m * scale2).  m is -1e30 while a row has
    // seen no live key.
    const int k_off = kt * kBK;
    const bool edge = k_off + kBK > sk
        || (causal && k_off + kBK - 1 > q_off)
        || (window > 0 && k_off <= q_off + kBQ - 1 - window);
    uint32_t live = ~0u;                  // bit i: s[i] is a live logit
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (edge) {
        const long long qi = q_off + row_a + 8 * ((i >> 1) & 1);
        const int ki = k_off + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const bool keep = ki < sk && (!causal || ki <= qi)
            && (window <= 0 || ki > qi - window);
        if (!keep) {
          live &= ~(1u << i);
          s[i] = kNegInf;
        }
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2], neg_ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx((m[r] - m_new) * scale2);
      m[r] = m_new;
      neg_ms[r] = -m_new * scale2;
      l[r] *= alpha[r];
    }
    // the rescale is skipped where no row max of the warp moved
    if (!__all_sync(~0u, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int b = 0; b < S::NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[b][i] *= alpha[(i >> 1) & 1];
    }

    // O += P V over four k16 steps of 16 keys; V's tile is (keys, d),
    // MN-major for the product.  P goes in as two bf16 parts, hi =
    // bf16(p) and lo = bf16(p - hi), each multiplied with V, so ~16 bits
    // of p reach the sum (l sums hi + lo).  Step t's parts are computed
    // while step t - 1's products run: the A operands alternate between
    // two register sets, a set reused once the products that read it
    // have retired.  A masked logit's p is 0, or 1 while its row has no
    // live key yet (the -1e30 fill's 2^(-1e30 - m)), and 0 past sk.
    uint32_t a[2][2][4];                  // [set][hi, lo][register]
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      uint32_t(&hi)[4] = a[t & 1][0];
      uint32_t(&lo)[4] = a[t & 1][1];
      if (t >= 2) tc::wgmma_wait<1>();    // step t - 2 has retired
      tc::fence_regs(hi);
      tc::fence_regs(lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {       // s[i], s[i + 1], i = 8 t + 2 e
        const int i = 8 * t + 2 * e, r = e & 1;
        float p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          p[u] = exp2_approx(__fmaf_rn(s[i + u], scale2, neg_ms[r]));
          if (edge && !((live >> (i + u)) & 1)) {
            const int ki = k_off + 8 * (i / 4) + 2 * (lane % 4) + u;
            p[u] = ki < sk && m[r] == kNegInf ? 1.f : 0.f;
          }
        }
        const __nv_bfloat162 h = __floats2bfloat162_rn(p[0], p[1]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 lw =
            __floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y);
        const float2 lf = __bfloat1622float2(lw);
        l[r] += (hf.x + lf.x) + (hf.y + lf.y);
        hi[e] = bf162_bits(h);
        lo[e] = bf162_bits(lw);
      }
      tc::fence_regs(hi);
      tc::fence_regs(lo);
#pragma unroll
      for (int b = 0; b < S::NB; ++b) tc::fence_regs(o[b]);
      tc::wgmma_fence();
#pragma unroll
      for (int b = 0; b < S::NB; ++b) {
        const uint64_t dv = tc::desc_b128(Ks(st) + S::KV_BYTES
                                          + b * kBK * 128 + t * 16 * 128);
        tc::wgmma_rs_bf16_n64(o[b], hi, dv, 1);
        tc::wgmma_rs_bf16_n64(o[b], lo, dv, 1);
      }
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < S::NB; ++b) tc::fence_regs(o[b]);
    __syncthreads();            // stage st is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
  }
  __nv_bfloat16* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_a + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int b = 0; b < S::NB; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = b * 64 + 8 * j + 2 * (lane % 4);
        if (col >= D) continue;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            o[b][4 * j + 2 * r] / den, o[b][4 * j + 2 * r + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<size_t>(row) * D + col) = pair;
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Dims<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), all contiguous
// bf16 on the device with 16-byte aligned bases; window 0 means none;
// launches on `stream` and returns the CUDA error code of the launch.
extern "C" int qappa_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int bh,
                                        int sq, int sk, int d, int causal,
                                        int window, float scale,
                                        void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || window < 0
      || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, bh, sq, sk, causal, window,
                               scale, s);
    case 32: return launch<32>(q, k, v, out, bh, sq, sk, causal, window,
                               scale, s);
    case 64: return launch<64>(q, k, v, out, bh, sq, sk, causal, window,
                               scale, s);
    case 128: return launch<128>(q, k, v, out, bh, sq, sk, causal, window,
                                 scale, s);
    case 256: return launch<256>(q, k, v, out, bh, sq, sk, causal, window,
                                 scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
