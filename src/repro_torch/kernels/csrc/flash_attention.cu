// Flash attention forward for Hopper, float32 operands: tiled
// online-softmax attention with both products on the TF32 tensor cores in
// three products on split operands (3xTF32).  bf16 operands go to
// flash_attention_tc.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, built around pl.pallas_call in flash_attention) and
// computes the same function: q, k, v (b*h, s, d) float32;
// logits = (q . k) * scale, masked to -1e30 where a key is in the
// future (causal) or outside the window (ki <= qi - window), the last q row
// aligned to the last key (qi = i + sk - sq); running max m, l = l * alpha
// + sum p, acc = acc * alpha + p . v; out = acc / max(l, 1e-30).
// Tiles wholly in the future or wholly outside every row's window are
// skipped, as the TPU kernel skips them.  Unlike it, any sq and sk are
// taken: keys past sk get p = 0 and rows past sq are not stored.
//
// What bounds it on an H100: operations.  At (1, 24, 4096, 128), causal,
// it does ~1.03e11 FLOP against ~200 MB of bytes.  One TF32 product
// rounds its operands to 11 significant bits (~1e-3 relative), outside
// the float32 bound of 1e-5, so each product runs three times on split
// operands (3xTF32): a = a_hi + a_lo with a_hi = tf32(a), rounded to
// nearest with ties away as cvt.rna.tf32.f32 rounds (by two integer
// operations: in an mma.sync design on an H100 they gave the results of
// the cvt instruction in less time), and a_lo = tf32(a - a_hi) (the difference is exact in
// float32); a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi on the
// tensor cores, the dropped a_lo . b_lo and the rounding of the lo parts
// leaving ~2^-21 relative a product.  3 x 1.031e11 FLOP at the
// 494.7 TFLOP/s dense TF32 peak is a 0.625 ms bound (1.539 ms for float32
// FMAs on the CUDA cores at 67 TFLOP/s).  The softmax (expf, the row max,
// the l sum) stays float32 on the CUDA cores; the library builds with
// -fmad=false and without fast-math.
//
// Layout: TF32 warpgroup products (wgmma, wgmma_tf32.cuh).  One block of
// two warpgroups (64 q rows each) per (b*h, 128-row q tile), the causal
// tiles launched heaviest first; one warpgroup of 64 rows at d 256.
// TF32 wgmma takes both shared-memory operands K-major, so the block
// keeps split copies in the 128-byte swizzled layout: Q hi and lo (split
// once), and per key tile K hi and lo and V^T hi and lo (V transposed,
// keys along the rows).  A tile of BK keys (32 at d 128, 64 below, 16 at
// d 256) arrives raw by 16-byte cp.async while the last one is
// multiplied, and the whole block splits it after a barrier (at d 256,
// where the staging does not fit in the 227 KB, straight from global
// memory).  S = Q K^T runs three products (lo . hi, hi . lo, hi . hi) per
// k8 step, a group of 4 steps (one 128-byte block of d) from 0 on the
// tensor cores, the next group issued before the last is added in float32
// (one chain over all of d and all keys, in an mma.sync design on an
// H100, left several times the plain version's own distance from
// float64; the short chains match it).  P stays in registers as the A operand of the PV
// products: the S accumulator holds keys 2t and 2t + 1 of a row, so V^T
// stores key 2t of each group of 8 at slot t and key 2t + 1 at slot t + 4
// and the A fragment's k indices t and t + 4 are those keys, no shuffle.
// Each key step's three products are issued as soon as its p is split,
// and the tile's product, accumulated from 0, is added to O * alpha in
// float32.  The second warpgroup issues its QK^T products once the first
// has issued its own (named barrier 1), so the first one's softmax runs
// beside the second one's products.  Shared memory: 226 KB at d 128.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int NWG = D == 256 ? 1 : 2;       // warpgroups, 64 rows each
  static constexpr int BQ = 64 * NWG;                // q rows a block
  static constexpr int BK = D == 256 ? 16 : D == 128 ? 32 : 64;  // keys
  static constexpr bool STAGED = D != 256;           // raw tiles by cp.async
  static constexpr int THREADS = 128 * NWG;
  static constexpr int DP = D < 32 ? 32 : D;         // d padded to 128 bytes
  static constexpr int NB = DP / 32;                 // 128-byte blocks of d
  static constexpr int NC = D < 128 ? D : 128;       // PV columns a product
  static constexpr int KB = (BK + 31) / 32;          // 128-byte key blocks
  static constexpr int Q_BYTES = BQ * DP * 4;        // each of hi, lo
  static constexpr int K_BYTES = BK * DP * 4;
  static constexpr int V_BYTES = KB * D * 128;       // V^T: rows of 32 keys
  static constexpr int KST = D, VST = D + 4;         // staging row strides
  static constexpr int STAGE_BYTES = STAGED ? BK * (KST + VST) * 4 : 0;
  // hi and lo of Q, K and V^T, the staging, and slack to align to 1024
  static constexpr int SMEM =
      2 * (Q_BYTES + K_BYTES + V_BYTES) + STAGE_BYTES + 1024;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// TF32 of x rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds: half a TF32 ulp added to the magnitude's bits, the 13 low bits
// cleared (a float32 with those bits zero, as the tensor cores read it)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x), lo = the exact float32 rest rounded to tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// byte offset of float column c of row r in a K-major tile of R rows,
// stored as 128-byte column blocks with the 128-byte swizzle
template <int R>
__device__ __forceinline__ uint32_t kmajor(int r, int c) {
  return tc::swizzle128((c / 32) * (R * 128) + r * 128 + (c % 32) * 4);
}

// four floats split into the hi and lo tiles at one 16-byte chunk
__device__ __forceinline__ void store_split4(uint8_t* hi, uint8_t* lo,
                                             uint32_t off, float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// the slot of key r of a tile in V^T's rows: in each group of 8 keys,
// key 2 t sits at slot t and key 2 t + 1 at slot t + 4, so that the PV
// product's A fragment (k indices t and t + 4) is the S accumulator's
// pair of keys 2 t, 2 t + 1 as it stands
__device__ __forceinline__ int key_slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

template <int N>
__device__ __forceinline__ void ss_tf32(float (&d)[N / 2], uint64_t a,
                                        uint64_t b, int scale_d) {
  if constexpr (N == 16) tc::wgmma_ss_tf32_n16(d, a, b, scale_d);
  else if constexpr (N == 32) tc::wgmma_ss_tf32_n32(d, a, b, scale_d);
  else tc::wgmma_ss_tf32_n64(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void rs_tf32(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  if constexpr (N == 16) tc::wgmma_rs_tf32_n16(d, a, b, scale_d);
  else if constexpr (N == 32) tc::wgmma_rs_tf32_n32(d, a, b, scale_d);
  else if constexpr (N == 64) tc::wgmma_rs_tf32_n64(d, a, b, scale_d);
  else tc::wgmma_rs_tf32_n128(d, a, b, scale_d);
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int sq,
             int sk, int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, DP = T::DP, NC = T::NC;
  constexpr int NJ = BK / 8, NCH = D / NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* Qh = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* Ql = Qh + T::Q_BYTES;
  uint8_t* Kh = Ql + T::Q_BYTES;
  uint8_t* Kl = Kh + T::K_BYTES;
  uint8_t* Vh = Kl + T::K_BYTES;
  uint8_t* Vl = Vh + T::V_BYTES;
  float* Kst = reinterpret_cast<float*>(Vl + T::V_BYTES);   // [BK][KST]
  float* Vst = Kst + BK * T::KST;                           // [BK][VST]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = wg * 64 + ((tid % 128) / 32) * 16;  // the warp's rows
  // global row index of tile row 0 (the last q row aligns to the last key)
  const long long q_off = static_cast<long long>(q0) + sk - sq;
  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  // the key tiles some row of the block needs
  const int n_kt = (sk + BK - 1) / BK;
  int kt_end = n_kt, kt_begin = 0;
  if (causal) {
    const long long last = q_off + BQ - 1;           // the last row's key
    if (last < static_cast<long long>(n_kt) * BK)
      kt_end = last < 0 ? 0 : static_cast<int>(last / BK + 1);
  }
  if (window > 0) {
    const long long first = q_off - window + 1;     // row 0's first live key
    if (first > 0)
      kt_begin = first >= sk ? n_kt : static_cast<int>(first / BK);
  }

  // raw K and V rows of tile kt into the staging buffers (rows past sk
  // zero-filled)
  auto stage = [&](int kt) {
    constexpr int kChunks = D / 4;
    for (int i = tid; i < 2 * BK * kChunks; i += T::THREADS) {
      const bool is_v = i >= BK * kChunks;
      const int c = is_v ? i - BK * kChunks : i;
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const int key = kt * BK + r;
      const float* src = (is_v ? vb : kb)
          + static_cast<size_t>(key < sk ? key : 0) * D + col;
      float* dst = is_v ? Vst + r * T::VST + col : Kst + r * T::KST + col;
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src,
                 key < sk ? 16 : 0);
    }
    cp_async_commit();
  };

  // Q split once for the block (rows past sq and columns past d are 0)
  for (int i = tid; i < BQ * DP / 4; i += T::THREADS) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const float4 x = q0 + r < sq && c < D
        ? ldg4(qb + static_cast<size_t>(q0 + r) * D + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split4(Qh, Ql, kmajor<BQ>(r, c), x);
  }
  if (T::STAGED && kt_begin < kt_end) stage(kt_begin);

  float o[NCH][NC / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) o[c][i] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_off = kt * BK;
    // the raw tile has landed and the last tile's products are done:
    // split it once for both warpgroups, then start the next tile's copy
    if (T::STAGED) cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < BK * DP / 4; i += T::THREADS) {      // K
      const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < D) {
        if (T::STAGED)
          x = *reinterpret_cast<const float4*>(Kst + r * T::KST + c);
        else if (k_off + r < sk)
          x = ldg4(kb + static_cast<size_t>(k_off + r) * D + c);
      }
      store_split4(Kh, Kl, kmajor<BK>(r, c), x);
    }
    for (int i = tid; i < BK * D / 4; i += T::THREADS) {       // V^T
      const int r = i % BK, c = (i / BK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (T::STAGED)
        x = *reinterpret_cast<const float4*>(Vst + r * T::VST + c);
      else if (k_off + r < sk)
        x = ldg4(vb + static_cast<size_t>(k_off + r) * D + c);
      const int slot = key_slot(r);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t h, lo;
        split_tf32(xs[u], h, lo);
        const uint32_t off = tc::swizzle128(
            (slot / 32) * (D * 128) + (c + u) * 128 + (slot % 32) * 4);
        *reinterpret_cast<uint32_t*>(Vh + off) = h;
        *reinterpret_cast<uint32_t*>(Vl + off) = lo;
      }
    }
    tc::fence_proxy_async();
    __syncthreads();
    if (T::STAGED && kt + 1 < kt_end) stage(kt + 1);

    // S = Q K^T: one group of 4 k8 steps per 128-byte block of d, each
    // from 0 on the tensor cores (lo . hi, hi . lo, hi . hi), the groups
    // added in float32.  Element i of s sits at row wrow + g +
    // 8 ((i >> 1) & 1), key k_off + 8 (i / 4) + 2 t + (i & 1)
    float s[BK / 2], part[2][BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    // the second warpgroup's products queue behind the first one's
    if (T::NWG == 2 && wg == 1)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int b = 0; b < T::NB; ++b) {
      // group b is issued before group b - 1 is added, so the tensor
      // cores stay busy while the CUDA cores add
      tc::fence_regs(part[b & 1]);
      tc::wgmma_fence();
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int qa = b * BQ * 128 + wg * 64 * 128 + w * 32;
        const int ka = b * BK * 128 + w * 32;
        const uint64_t a_hi = tc::desc_b128(Qh + qa);
        const uint64_t b_hi = tc::desc_b128(Kh + ka);
        ss_tf32<BK>(part[b & 1], tc::desc_b128(Ql + qa), b_hi, w > 0);
        ss_tf32<BK>(part[b & 1], a_hi, tc::desc_b128(Kl + ka), 1);
        ss_tf32<BK>(part[b & 1], a_hi, b_hi, 1);
      }
      tc::wgmma_commit();
      if (b > 0) {
        tc::wgmma_wait<1>();
        tc::fence_regs(part[(b - 1) & 1]);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] = __fadd_rn(s[i], part[(b - 1) & 1][i]);
      }
    }
    if (T::NWG == 2 && wg == 0)
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    tc::wgmma_wait<0>();
    tc::fence_regs(part[(T::NB - 1) & 1]);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = __fadd_rn(s[i], part[(T::NB - 1) & 1][i]);

    // mask, row max over the quad of lanes that share a row, online
    // rescale; m is -1e30 while a row has seen no live key
    const bool edge = k_off + BK > sk
        || (causal && k_off + BK - 1 > q_off)
        || (window > 0 && k_off <= q_off + BQ - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      bool keep = true;
      if (edge) {
        const long long qi = q_off + wrow + g + 8 * ((i >> 1) & 1);
        const int ki = k_off + 8 * (i / 4) + 2 * t + (i & 1);
        keep = ki < sk && (!causal || ki <= qi)
            && (window <= 0 || ki > qi - window);
      }
      s[i] = keep ? s[i] * scale : kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p (keys past sk get 0), split into the A fragments of the PV
    // steps; O = O * alpha + P V, NC columns a product: the tile's product
    // accumulates from 0 on the tensor cores and is added in float32.
    // With one column chunk, step j's products are issued as soon as its
    // fragments are split, while the next step's p is computed
    uint32_t p_hi[NJ][4], p_lo[NJ][4];
    float pv[NC / 2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[4 * j + e] - m[e >> 1]);
        if (edge && k_off + 8 * j + 2 * t + (e & 1) >= sk) p[e] = 0.f;
        l[e >> 1] += p[e];
      }
      split_tf32(p[0], p_hi[j][0], p_lo[j][0]);         // (g, key 2t)
      split_tf32(p[2], p_hi[j][1], p_lo[j][1]);         // (g + 8, key 2t)
      split_tf32(p[1], p_hi[j][2], p_lo[j][2]);         // (g, key 2t + 1)
      split_tf32(p[3], p_hi[j][3], p_lo[j][3]);         // (g + 8, key 2t + 1)
      if constexpr (NCH == 1) {
        tc::fence_regs(p_hi[j]);
        tc::fence_regs(p_lo[j]);
        if (j == 0) tc::fence_regs(pv);
        tc::wgmma_fence();
        const int va = (j / 4) * (D * 128) + (j % 4) * 32;
        const uint64_t v_hi = tc::desc_b128(Vh + va);
        rs_tf32<NC>(pv, p_lo[j], v_hi, j > 0);
        rs_tf32<NC>(pv, p_hi[j], tc::desc_b128(Vl + va), 1);
        rs_tf32<NC>(pv, p_hi[j], v_hi, 1);
        tc::wgmma_commit();
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if constexpr (NCH > 1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          tc::fence_regs(p_hi[j]);
          tc::fence_regs(p_lo[j]);
        }
        tc::fence_regs(pv);
        tc::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int va = (j / 4) * (D * 128) + c * NC * 128 + (j % 4) * 32;
          const uint64_t v_hi = tc::desc_b128(Vh + va);
          rs_tf32<NC>(pv, p_lo[j], v_hi, j > 0);
          rs_tf32<NC>(pv, p_hi[j], tc::desc_b128(Vl + va), 1);
          rs_tf32<NC>(pv, p_hi[j], v_hi, 1);
        }
        tc::wgmma_commit();
      }
      tc::wgmma_wait<0>();
      tc::fence_regs(pv);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {    // live until the products retired
        tc::fence_regs(p_hi[j]);
        tc::fence_regs(p_lo[j]);
      }
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        o[c][i] = __fadd_rn(o[c][i] * alpha[(i >> 1) & 1], pv[i]);
    }
  }
  if (T::STAGED) cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
  }
  float* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        const float2 val = make_float2(o[c][4 * n + 2 * r] / den,
                                       o[c][4 * n + 2 * r + 1] / den);
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * D
                                   + c * NC + 8 * n + 2 * t) = val;
      }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int sq, int sk, int causal, int window, float scale,
           cudaStream_t stream) {
  using T = Tile<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if ((sq + T::BQ - 1) / T::BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (sq + T::BQ - 1) / T::BQ);
  flash_kernel<D><<<grid, T::THREADS, T::SMEM, stream>>>(
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
// float32 on the device with 16-byte aligned bases; window 0 means none;
// launches on `stream` and returns the CUDA error code of the launch.
extern "C" int qappa_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int sq, int sk, int d, int causal,
                                     int window, float scale, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || window < 0
      || reinterpret_cast<uintptr_t>(q) % 16
      || reinterpret_cast<uintptr_t>(k) % 16
      || reinterpret_cast<uintptr_t>(v) % 16
      || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out), bh,
                  sq, sk, d, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
