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
// the row's global maximum, as the oracle ref.w8a8_decode_attention_ref
// does; the TPU kernel's running maximum differs only by rounding.  Built
// without fast-math, so expf and every division are the IEEE functions
// PyTorch's plain version calls.
//
// What bounds it on an H100: bytes.  K and V (int8) plus their float32
// scales are read once, ~34.6 MB a layer at b 4, S 4096, kvh 8, hd 128, a
// 10.3 us bound at 3.35 TB/s; its few int8 operations per byte are far
// below the card's ridge.  Keys past pos are skipped, so a short context
// reads only its own rows of the cache.
//
// Layout: S is split across blocks, a grid of (b * kvh, splits) with
// splits of `split_keys` keys (a multiple of 4; of bs too where bs < S, so
// a bs block never straddles two splits), as kernels/w8a8_decode.plan
// picks them: 288 blocks at b 4, kvh 8, S 4096 (one block per (b, g) was
// 32 blocks on 132 SMs).  Splits that start past pos exit at once; split
// 0 always runs, so a row with no live key still gets its output (0).
// The plain version's float order is kept across the splits in three
// launches on one stream:
//   1. logits: a thread per key dots the key's hd bytes (16-byte loads)
//      with the rep q rows; logits go to a float32 scratch buffer and each
//      split's row maxima to `smax`;
//   2. exp: the row's global max m is the max over the live splits' maxima
//      (order-free); p = expf(logit - m), pf = p * v_scale overwrites the
//      logit; each split's float64 l partial and max |pf| go to `lpart`,
//      `pmax`;
//   3. PV: per bs block, p_s = max pf / 127 (with bs = S the max over the
//      live splits' `pmax`, order-free; else the block's own, inside the
//      split); codes staged in shared memory, four keys to a word, V words
//      byte-transposed so one __dp4a adds four code x value products, the
//      slices meeting by shared int32 atomics.  With one block (bs = S)
//      the splits add their int32 sums into a zeroed workspace (atomics,
//      exact); with several, each split stores its blocks' float(oi) * p_s
//      terms.  The split that arrives last (a per-(b, g) counter) sums the
//      l partials in float64 in split order, forms acc in block order
//      (0 + term, block after block, as the plain version does), writes
//      out = acc / max(l, 1e-30), and leaves the sums and its counter
//      zeroed for the next call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;      // keys whose codes are staged at once
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

// The launches' shared arguments: shapes, the split and the scratch
// regions (float64 l partials, then float32 logits / pf, split maxima,
// split max |pf|, block terms) and the workspace (int32 sums, counters).
struct Args {
  const int8_t* q;
  const float* factor;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* pos;
  void* out;
  double* lpart;          // [bg][splits][rep]
  float* sc;              // [bg][rep][S]
  float* smax;            // [bg][splits][rep]
  float* pmax;            // [bg][splits][rep]
  float* terms;           // [bg][nb][rep][hd], nb = S / bs > 1 only
  int* sums;              // [bg][rep][hd], nb == 1 only
  unsigned* counters;     // [bg]
  int out_bf16, kvh, rep, hd, S, bs, split_keys, splits;
  bool vec16;
};

// the keys of split sp: [k0, k1) within the live keys, and how many
// splits hold live keys (at least 1: split 0 always runs)
struct Range {
  int bg, b, g, sp, n_live, k0, k1, live_splits;
};

__device__ __forceinline__ Range range_of(const Args& a) {
  Range r;
  r.bg = blockIdx.x;
  r.b = r.bg / a.kvh;
  r.g = r.bg % a.kvh;
  r.sp = blockIdx.y;
  const int p = a.pos[r.b];
  r.n_live = p < 0 ? 0 : min(p, a.S - 1) + 1;      // keys 0..n_live-1
  r.k0 = r.sp * a.split_keys;
  r.k1 = min(r.k0 + a.split_keys, r.n_live);
  r.live_splits = max(1, (r.n_live + a.split_keys - 1) / a.split_keys);
  return r;
}

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

// ---- launch 1: logits of the split's live keys and their row maxima ----
template <int R>
__global__ void __launch_bounds__(kThreads) logits_kernel(Args a) {
  __shared__ int qw[R][kMaxHd / 4];          // q codes, 4 to a word
  __shared__ float fac[R];
  __shared__ float red[R][kWarps];
  __shared__ float mx_out[R];
  const Range rg = range_of(a);
  if (rg.sp > 0 && rg.k0 >= rg.n_live) return;
  const int tid = threadIdx.x, words = a.hd / 4, rep = a.rep;
  for (int i = tid; i < R * (kMaxHd / 4); i += kThreads) {
    const int r = i / (kMaxHd / 4), w = i % (kMaxHd / 4);
    qw[r][w] = (r < rep && w < words)
        ? reinterpret_cast<const int*>(
              a.q + (static_cast<size_t>(rg.bg) * rep + r) * a.hd)[w]
        : 0;
  }
  if (tid < R) fac[tid] = tid < rep ? a.factor[rg.bg * rep + tid] : 0.f;
  __syncthreads();

  float* sc = a.sc + static_cast<size_t>(rg.bg) * rep * a.S;
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = kNegInf;
  for (int s = rg.k0 + tid; s < rg.k1; s += kThreads) {
    const size_t row = (static_cast<size_t>(rg.b) * a.S + s) * a.kvh + rg.g;
    const int8_t* kr = a.k + row * a.hd;
    int acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0;
    if (a.vec16) {
#pragma unroll 8
      for (int w4 = 0; w4 < a.hd / 16; ++w4) {
        const int4 kv = reinterpret_cast<const int4*>(kr)[w4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = __dp4a(kv.x, qw[r][4 * w4], acc[r]);
          acc[r] = __dp4a(kv.y, qw[r][4 * w4 + 1], acc[r]);
          acc[r] = __dp4a(kv.z, qw[r][4 * w4 + 2], acc[r]);
          acc[r] = __dp4a(kv.w, qw[r][4 * w4 + 3], acc[r]);
        }
      }
    } else {
      for (int w = 0; w < words; ++w) {
        const int kw = reinterpret_cast<const int*>(kr)[w];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = __dp4a(kw, qw[r][w], acc[r]);
      }
    }
    const float ksv = a.ks[row];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        const float lg = (static_cast<float>(acc[r]) * fac[r]) * ksv;
        sc[static_cast<size_t>(r) * a.S + s] = lg;
        mx[r] = fmaxf(mx[r], lg);
      }
    }
  }
  block_max<R>(mx, red, mx_out);
  if (tid < rep)
    a.smax[(static_cast<size_t>(rg.bg) * a.splits + rg.sp) * rep + tid] =
        mx_out[tid];
}

// ---- launch 2: p against the global max, l partials, pf, max |pf| ------
template <int R>
__global__ void __launch_bounds__(kThreads) exp_kernel(Args a) {
  __shared__ float m[R];
  __shared__ float red[R][kWarps];
  __shared__ double lred[R][kWarps];
  __shared__ float pm_out[R];
  const Range rg = range_of(a);
  if (rg.sp > 0 && rg.k0 >= rg.n_live) return;
  const int tid = threadIdx.x, rep = a.rep;
  if (tid < R) {
    float x = kNegInf;
    if (tid < rep)
      for (int sp = 0; sp < rg.live_splits; ++sp)
        x = fmaxf(x, a.smax[(static_cast<size_t>(rg.bg) * a.splits + sp)
                            * rep + tid]);
    m[tid] = x;
  }
  __syncthreads();

  float* sc = a.sc + static_cast<size_t>(rg.bg) * rep * a.S;
  double lsum[R];
  float pm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lsum[r] = 0.0;
    pm[r] = 0.f;
  }
  for (int s = rg.k0 + tid; s < rg.k1; s += kThreads) {
    const float vsv = a.vs[(static_cast<size_t>(rg.b) * a.S + s) * a.kvh
                           + rg.g];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        float* e = sc + static_cast<size_t>(r) * a.S + s;
        const float pv = expf(*e - m[r]);
        lsum[r] += static_cast<double>(pv);
        const float pf = pv * vsv;
        *e = pf;
        pm[r] = fmaxf(pm[r], fabsf(pf));
      }
    }
  }
  block_max<R>(pm, red, pm_out);
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double w = warp_sum(lsum[r]);
    if (lane == 0) lred[r][warp] = w;
  }
  __syncthreads();
  if (tid < rep) {
    double x = 0.0;
    for (int i = 0; i < kWarps; ++i) x += lred[tid][i];
    const size_t at = (static_cast<size_t>(rg.bg) * a.splits + rg.sp) * rep
        + tid;
    a.lpart[at] = x;
    a.pmax[at] = pm_out[tid];
  }
}

// ---- launch 3: codes, int8 PV, and the epilogue by the last split ------
template <int R>
__global__ void __launch_bounds__(kThreads) pv_kernel(Args a) {
  __shared__ int codes[R][kChunk / 4];       // probability codes, 4 a word
  __shared__ int oi[R][kMaxHd];              // int32 PV of the current block
  __shared__ float red[R][kWarps];
  __shared__ float ps[R];
  __shared__ float den[R];
  __shared__ bool last;
  const Range rg = range_of(a);
  if (rg.sp > 0 && rg.k0 >= rg.n_live) return;
  const int tid = threadIdx.x, rep = a.rep, hd = a.hd, words = hd / 4;
  const int nb = a.S / a.bs;
  for (int i = tid; i < R * kMaxHd; i += kThreads) oi[i / kMaxHd][i % kMaxHd] = 0;
  if (nb == 1 && tid < R) {
    float x = 0.f;
    if (tid < rep)
      for (int sp = 0; sp < rg.live_splits; ++sp)
        x = fmaxf(x, a.pmax[(static_cast<size_t>(rg.bg) * a.splits + sp)
                            * rep + tid]);
    ps[tid] = x / 127.0f;
  }
  __syncthreads();

  const float* sc = a.sc + static_cast<size_t>(rg.bg) * rep * a.S;
  const int slices = kThreads / words;
  const int col_word = tid % words, slice = tid / words;
  // one segment a bs block (the split holds whole blocks), or the whole
  // split when there is one block
  const int seg = nb == 1 ? a.split_keys : a.bs;
  for (int s0 = rg.k0; s0 < rg.k1; s0 += seg) {
    const int s1 = min(s0 + seg, rg.k1);
    if (nb > 1) {
      float pm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pm[r] = 0.f;
      for (int s = s0 + tid; s < s1; s += kThreads)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rep)
            pm[r] = fmaxf(pm[r], fabsf(sc[static_cast<size_t>(r) * a.S + s]));
      block_max<R>(pm, red, ps);
      if (tid < R) ps[tid] = ps[tid] / 127.0f;
      __syncthreads();
    }

    int acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int n = min(kChunk, s1 - c0);
      int8_t* cb = reinterpret_cast<int8_t*>(&codes[0][0]);
      for (int i = tid; i < R * kChunk; i += kThreads) {
        const int r = i / kChunk, t = i % kChunk;
        float code = 0.f;
        if (r < rep && t < n)
          code = rintf(sc[static_cast<size_t>(r) * a.S + c0 + t]
                       / fmaxf(ps[r], 1e-12f));
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
                      a.v + ((static_cast<size_t>(rg.b) * a.S + s + j)
                                 * a.kvh + rg.g) * hd)[col_word]
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
            const int cw = codes[r][qd];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(cw, cols[c], acc[r][c]);
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
            atomicAdd(&oi[r][4 * col_word + c], acc[r][c]);
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const size_t o = static_cast<size_t>(rg.bg) * rep * hd + i;
      if (nb == 1) {
        if (oi[r][d] != 0) atomicAdd(a.sums + o, oi[r][d]);
      } else {
        a.terms[(static_cast<size_t>(rg.bg) * nb + s0 / a.bs) * rep * hd + i] =
            static_cast<float>(oi[r][d]) * ps[r];
      }
      oi[r][d] = 0;
    }
    __syncthreads();
  }

  // the last split of (b, g) to arrive writes the output
  __threadfence();
  __syncthreads();
  unsigned* counter = a.counters + rg.bg;
  if (tid == 0) last = atomicAdd(counter, 1u) == rg.live_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < rep) {
    double x = 0.0;
    for (int sp = 0; sp < rg.live_splits; ++sp)
      x += a.lpart[(static_cast<size_t>(rg.bg) * a.splits + sp) * rep + tid];
    den[tid] = fmaxf(static_cast<float>(x), 1e-30f);
  }
  __syncthreads();
  const int live_blocks = (rg.n_live + a.bs - 1) / a.bs;
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd;
    const size_t o = static_cast<size_t>(rg.bg) * rep * hd + i;
    float acc = 0.f;
    if (nb == 1) {
      int* at = a.sums + o;
      acc = acc + static_cast<float>(__ldcg(at)) * ps[r];
      *at = 0;
    } else {
      for (int blk = 0; blk < live_blocks; ++blk)
        acc = acc + __ldcg(a.terms + (static_cast<size_t>(rg.bg) * nb + blk)
                                         * rep * hd + i);
    }
    const float val = acc / den[r];
    if (a.out_bf16)
      reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(val);
    else
      reinterpret_cast<float*>(a.out)[o] = val;
  }
  if (tid == 0) *counter = 0;                 // ready for the next call
}

template <int R>
int launch(const Args& a, int bg, cudaStream_t stream, int* info) {
  const dim3 grid(bg, a.splits);
  info[1] = grid.x;
  info[2] = grid.y;
  logits_kernel<R><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++info[0];
  exp_kernel<R><<<grid, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++info[0];
  pv_kernel<R><<<grid, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++info[0];
  return 0;
}

}  // namespace

// q (b, kvh, rep, hd) int8 codes, factor (b, kvh, rep) f32, k/v (b, S, kvh,
// hd) int8, k_scale/v_scale (b, S, kvh) f32, pos (b,) int32 and out
// (b, kvh, rep, hd) f32 or bf16, all contiguous on the device.  The split:
// `split_keys` keys a split (a multiple of 4, and of bs where bs < S).
// `scratch` (scratch_len float32, uninitialized, 8-byte aligned) holds
// 4 * splits * rep + rep * S floats per (b, g), plus nb * rep * hd when
// nb = S / bs > 1; `workspace` (workspace_len int32, zero, and left zero)
// holds rep * hd sums and one counter per (b, g).  Launches three kernels
// on `stream` and returns the CUDA error code of the first that failed.
// `info` (3 ints, host memory) receives the kernels launched and the
// grid's x and y (b * kvh, splits).
extern "C" int qappa_w8a8_decode(const void* q, const void* factor,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* pos, void* out, void* scratch,
                                 long long scratch_len, void* workspace,
                                 long long workspace_len, int out_bf16,
                                 int b, int kvh, int rep, int hd, int S,
                                 int bs, int split_keys, int* info,
                                 void* stream) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = info[1] = info[2] = 0;
  if (b < 1 || kvh < 1 || rep < 1 || rep > 16 || hd < 4 || hd % 4
      || hd > kMaxHd || S < 1 || bs < 1 || S % bs
      || static_cast<long long>(bs) * 127 * 127 >= (1LL << 31)
      || split_keys < 4 || split_keys % 4 || (bs < S && split_keys % bs)
      || reinterpret_cast<uintptr_t>(q) % 4 || reinterpret_cast<uintptr_t>(k) % 4
      || reinterpret_cast<uintptr_t>(v) % 4
      || reinterpret_cast<uintptr_t>(scratch) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bg = static_cast<long long>(b) * kvh;
  const int splits = (S + split_keys - 1) / split_keys;
  const int nb = S / bs;
  const long long per_split = static_cast<long long>(splits) * rep;
  const long long need_scratch =
      bg * (4 * per_split + static_cast<long long>(rep) * S
            + (nb > 1 ? static_cast<long long>(nb) * rep * hd : 0));
  const long long need_ws = bg * rep * hd + bg;
  if (splits > 65535 || bg > 0x7fffffffLL || scratch == nullptr
      || workspace == nullptr || scratch_len < need_scratch
      || workspace_len < need_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const int8_t*>(q);
  a.factor = static_cast<const float*>(factor);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  auto* f = static_cast<float*>(scratch);
  a.lpart = reinterpret_cast<double*>(f);
  a.sc = f + 2 * bg * per_split;
  a.smax = a.sc + bg * rep * S;
  a.pmax = a.smax + bg * per_split;
  a.terms = a.pmax + bg * per_split;
  a.sums = static_cast<int*>(workspace);
  a.counters = reinterpret_cast<unsigned*>(a.sums + bg * rep * hd);
  a.out_bf16 = out_bf16;
  a.kvh = kvh;
  a.rep = rep;
  a.hd = hd;
  a.S = S;
  a.bs = bs;
  a.split_keys = split_keys;
  a.splits = splits;
  // 16-byte loads of K rows when every row starts on a 16-byte boundary
  a.vec16 = hd % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(bg);
  if (rep <= 1) return launch<1>(a, n, s, info);
  if (rep <= 2) return launch<2>(a, n, s, info);
  if (rep <= 4) return launch<4>(a, n, s, info);
  if (rep <= 8) return launch<8>(a, n, s, info);
  return launch<16>(a, n, s, info);
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
