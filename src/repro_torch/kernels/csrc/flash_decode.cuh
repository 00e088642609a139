// Flash attention's decode regime for Hopper: few q rows against a long
// context, the kv heads read in place, the keys split across blocks.
// flash_decode.cu builds it for bf16 operands and flash_decode_f32.cu for
// float32, each into its own library, so that nvcc compiles the two sets
// of instances in parallel.
//
// Replaces, for calls with few q rows, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (_flash_kernel, built around
// pl.pallas_call in flash_attention); flash_attention_tc.cu (bf16) and
// flash_attention.cu (float32) keep the tile regime.  Same function:
// softmax(q k^T * scale) v over the kv heads broadcast to h, q head
// g * rep + j reading kv head g; logits in float32, masked to -1e30 where
// a key is in the future (causal) or outside the window (ki <= qi -
// window), the last q row aligned to the last key (qi = i + sk - sq);
// out = acc / max(l, 1e-30) in q's dtype.  q is (b, sq, h, d) and k, v
// (b, sk, kvh, d), each read through its strides (d contiguous), so the
// model's context caches are read where they lie: no repeat of the kv
// heads and no transposed copy.  bf16 or float32 operands; the logits,
// the softmax and P.V stay in float32 on the CUDA cores (fmaf), with the
// softmax in base 2 (the SFU's 2^x, about 2 ulp, of logits scaled by
// scale * log2(e)).
//
// What bounds it on an H100: bytes.  q, k and v are read once and out
// written once: llama-3.2-vision's decode cross-attention, q (4, 1, 64,
// 128) against k, v (4, 1601, 8, 128) bf16, is 26.2 MB, 7.8 us at 3.35
// TB/s, against 0.21 GFLOP (3.2 us at the 67 TFLOP/s float32 rate).  The
// tile regime reads k, v once for every q head (8 times here) and needs
// them repeated and transposed first.  As built it does not reach that
// bound (tools/time_flash_decode.py, PERF.md): llama's shape spends ~150
// instructions a key and lane (its 64 fmaf, the bf16 conversions, the
// shuffles, the softmax), so its key loop is bound by issue; a fixed
// ~6-9 us goes to q's load, the merges and the split counter.  Staging
// the keys by cp.async into a shared-memory ring, a register prefetch and
// the splits merged in a thread-block cluster's shared memory were timed
// and did not help (the cluster merge took 1.6x as long).
//
// Layout: a grid of (b * kvh, splits); each block takes all rep * sq q
// rows of its kv head (R rows) and one split of the keys, so a key is
// read from memory once for its rep q heads.  kernels/flash_attention
// .decode_plan owns the layout (the entry only checks it): it picks the
// rows a group keeps, the slices of a split, and the splits so that the
// grid fills the card's 132 SMs (256 blocks at llama's and whisper's
// decode shapes, where one block per (b, g) gave 32 and 64), each split
// reading at least 4x the bytes its partial writes.  Inside a block, 8 warps of lane groups: a group
// of L lanes (at most 8) takes one key at a time, each lane W 16-byte
// words of the key's row (word i of lane j the row's word i * L + j), so
// each load of a group is L x 16 contiguous bytes.  A
// group keeps RT q rows (a "pass") in registers, dots them with its
// lanes' part of the key (fmaf), sums the parts by xor shuffles (every
// lane ends with the same bits), and keeps its own online softmax (m, l
// and RT x E of acc) over the keys of its slice: every `slices`-th key of
// the split, C keys scored before one rescale.  The groups of a warp
// take the passes of one slice, so they load the same rows.  With more
// than one slice the groups' partials meet in shared memory (max, then
// weights 2^(m - M)); the block's partial (M, l, acc over R rows) goes to
// the scratch buffer, and the last split of a (b, g) to arrive (a
// counter in the per-stream zeroed workspace, kernels/_workspace.py, left
// zero again) merges the splits the same way and writes out.  One split:
// the block writes out itself.
//
// Ragged sk: the last split is shorter and keys past it are not read (a
// group whose slice ends early scores zeros and drops them).  Dead splits:
// the planner splits only [key_lo, sk), key_lo the first key any row can
// see (window), so no block reads keys that every row masks; the masked
// keys it does read score -1e30 and weigh 2^(-1e30 - m) = 0.  Rows with
// no live key (causal, sq > sk, qi < 0): every logit is -1e30, so, as in
// a dense softmax with masked logits at -1e30, each key weighs 1 and out
// is the mean of v over all sk keys (the planner then keeps key_lo = 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[3], ks[3], vs[3], os[3];  // strides (elements): b, head, s
  float* part;          // [bg][splits][R] m, then l, then [..][R][d] acc
  unsigned* counters;   // [bg], zero between calls
  int kvh, rep, sq, sk, R;
  int causal, window;   // window 0: none
  float scale_log2;     // scale * log2(e)
  int key_lo, split_keys, splits, slices;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A lane's W 16-byte words of a row (16-byte aligned) of a group of L
// lanes: word i of lane gl is the row's word i * L + gl, so each load of
// the group reads L x 16 contiguous bytes; E = W * 16 / sizeof(T)
// elements
template <typename T, int W, int L>
struct Row {
  static constexpr int E = W * 16 / static_cast<int>(sizeof(T));
  uint4 w[W];

  __device__ __forceinline__ void load(const T* row, int gl) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = __ldg(reinterpret_cast<const uint4*>(row) + i * L + gl);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void to_float(float (&x)[E]) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 2) {
          x[i * 8 + 2 * j] = bf16_lo(u[j]);
          x[i * 8 + 2 * j + 1] = bf16_hi(u[j]);
        } else {
          x[i * 4 + j] = __uint_as_float(u[j]);
        }
      }
    }
  }
};

// 2^x by the SFU's approximation (about 2 ulp), as fast-math's exp2f; 0
// at -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool masked(const Args& a, int key, int qi) {
  return (a.causal && key > qi) || (a.window && key <= qi - a.window);
}

// row r of a block (q position r / rep, q head g * rep + r % rep) in a
// tensor of strides st (b, head, s)
__device__ __forceinline__ long long row_offset(const long long* st,
                                                const Args& a, int bi, int g,
                                                int r) {
  const int i = r / a.rep, j = r - i * a.rep;
  return bi * st[0] + static_cast<long long>(g * a.rep + j) * st[1]
         + i * st[2];
}

// A row's 16-byte words (V elements each), the lanes a key takes (at
// most 8: fewer shuffles a logit), the words and elements a lane takes,
// the groups a warp and a block hold, and the keys a group scores before
// one rescale (fewer where a lane's words take more registers)
template <typename T, int D>
struct Cfg {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int WORDS = D / V;
  static constexpr int L = WORDS < 8 ? WORDS : 8;
  static constexpr int W = WORDS / L;
  static constexpr int E = W * V;
  static constexpr int NG = 32 / L;
  static constexpr int NGB = kWarps * NG;
  static constexpr int C = W >= 4 ? 1 : 4 / W;
  static constexpr int RT_MAX = 64 / E;     // q and acc in 128 registers
};

// the column of a lane's element e (word e / V of the lane)
template <int V, int L>
__device__ __forceinline__ int column(int gl, int e) {
  return ((e / V) * L + gl) * V + e % V;
}

// The n partials of a row, entry j at x[j * stride] (its m, replaced in
// place by its weight 2^(m - M), 0 where m is -inf) and l[j * stride], by
// one warp: M, the max, to *M_out, and the sum of weight x l returned to
// every lane
__device__ __forceinline__ float weigh_row(float* x, const float* l, int n,
                                           int stride, float* M_out) {
  const int lane = threadIdx.x & 31;
  float M = -INFINITY;
  for (int j = lane; j < n; j += 32) M = fmaxf(M, x[j * stride]);
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float m = x[j * stride];
    const float w = m == -INFINITY ? 0.f : ex2(m - M);
    x[j * stride] = w;
    s = fmaf(w, l[j * stride], s);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  *M_out = M;
  return s;
}

// A row's result at column c: out when the call has one split, else the
// block's partial (M, l, acc) in the scratch buffer
template <typename T, int D>
__device__ __forceinline__ void emit(const Args& a, int bg, int split, int r,
                                     int c, float M, float l, float acc) {
  if (a.splits == 1) {
    const int bi = bg / a.kvh, g = bg - bi * a.kvh;
    store(static_cast<T*>(a.out) + row_offset(a.os, a, bi, g, r) + c,
          acc / fmaxf(l, 1e-30f));
    return;
  }
  const long long row =
      (static_cast<long long>(bg) * a.splits + split) * a.R + r;
  const long long nrow = static_cast<long long>(gridDim.x) * a.splits * a.R;
  if (c == 0) {
    a.part[row] = M;
    a.part[nrow + row] = l;
  }
  a.part[2 * nrow + row * D + c] = acc;
}

template <typename T, int D, int RT>
__global__ void __launch_bounds__(kThreads,
                                  RT * Cfg<T, D>::E <= 32 ? 2 : 1)
flash_decode_kernel(Args a) {
  using K = Cfg<T, D>;
  constexpr int V = K::V, W = K::W, E = K::E, L = K::L, NG = K::NG;
  constexpr int NGB = K::NGB, C = K::C;
  extern __shared__ float smem[];
  __shared__ bool last;
  const int bg = blockIdx.x, split = blockIdx.y;
  const int bi = bg / a.kvh, g = bg - bi * a.kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gl = lane % L;
  const int R = a.R, P = (R + RT - 1) / RT, slices = a.slices;
  const int units = P * slices;
  const int k0 = a.key_lo + split * a.split_keys;
  const int n = min(a.sk - k0, a.split_keys);
  const int nt = (n + slices - 1) / slices;    // keys of slice 0
  const T* kb = static_cast<const T*>(a.k) + bi * a.ks[0] + g * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + bi * a.vs[0] + g * a.vs[1];
  float* um = smem;                        // [units][RT] m, then weights
  float* ul = um + units * RT;             // [units][RT] l
  float* uacc = ul + units * RT;           // [units][RT][D] acc
  float* rowm = uacc + units * RT * D;     // [R] the block's M
  float* rowl = rowm + R;                  // [R] the block's l

  // each group takes units (pass, slice); with one slice a group may
  // take several
  for (int ub = warp * NG; ub < units; ub += NGB) {
    const int u = ub + lane / L;
    const bool uok = u < units;
    const int pass = uok ? u % P : 0, slice = uok ? u / P : 0;
    float q[RT][E], acc[RT][E], m[RT], l[RT];
    int qi[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const int r = pass * RT + rr;
      if (uok && r < R) {
        Row<T, W, L> w;
        w.load(static_cast<const T*>(a.q) + row_offset(a.qs, a, bi, g, r),
               gl);
        w.to_float(q[rr]);
        qi[rr] = r / a.rep + a.sk - a.sq;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) q[rr][e] = 0.f;
        qi[rr] = a.sk - 1;
      }
      m[rr] = -INFINITY;
      l[rr] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
    }
    // the C keys from t0 on of this group's slice
    auto fetch = [&](Row<T, W, L> (&kr)[C], Row<T, W, L> (&vr)[C], int t0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = slice + (t0 + c) * slices;   // key within the split
        if (uok && t0 + c < nt && at < n) {
          kr[c].load(kb + (k0 + at) * a.ks[2], gl);
          vr[c].load(vb + (k0 + at) * a.vs[2], gl);
        } else {
          kr[c].zero();
          vr[c].zero();
        }
      }
    };
    auto score = [&](const Row<T, W, L> (&kr)[C],
                     const Row<T, W, L> (&vr)[C], int t0) {
      int key[C];
      bool ok[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = slice + (t0 + c) * slices;
        key[c] = k0 + at;
        ok[c] = uok && t0 + c < nt && at < n;
      }
      float s[C][RT];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float kf[E];
        kr[c].to_float(kf);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) x = fmaf(q[rr][e], kf[e], x);
          s[c][rr] = x;
        }
      }
      // the lanes' parts summed: every lane of the group the same bits
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int rr = 0; rr < RT; ++rr)
            s[c][rr] += __shfl_xor_sync(kFull, s[c][rr], off);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        float mc = -INFINITY;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float x = s[c][rr] * a.scale_log2;
          if (!ok[c])
            x = -INFINITY;
          else if (masked(a, key[c], qi[rr]))
            x = kMasked;
          s[c][rr] = x;
          mc = fmaxf(mc, x);
        }
        if (mc > m[rr]) {
          const float alpha = m[rr] == -INFINITY ? 0.f : ex2(m[rr] - mc);
          l[rr] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[rr][e] *= alpha;
          m[rr] = mc;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float p =
              s[c][rr] == -INFINITY ? 0.f : ex2(s[c][rr] - m[rr]);
          s[c][rr] = p;
          l[rr] += p;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float vf[E];
        vr[c].to_float(vf);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[rr][e] = fmaf(s[c][rr], vf[e], acc[rr][e]);
        }
      }
    };
    Row<T, W, L> ka[C], va[C];
    for (int t0 = 0; t0 < nt; t0 += C) {
      fetch(ka, va, t0);
      score(ka, va, t0);
    }
    if (!uok) continue;
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const int r = pass * RT + rr;
      if (slices == 1) {
        if (r < R) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            emit<T, D>(a, bg, split, r, column<V, L>(gl, e), m[rr], l[rr],
                       acc[rr][e]);
        }
        continue;
      }
      if (gl == 0) {
        um[u * RT + rr] = m[rr];
        ul[u * RT + rr] = l[rr];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        uacc[(u * RT + rr) * D + column<V, L>(gl, e)] = acc[rr][e];
    }
  }

  if (slices > 1) {
    // the slices' partials of each row: M, the weights 2^(m - M) (in
    // place of m) and l; then acc
    // (unit sl * P + pass holds row r = pass * RT + rr at sl * P * RT + r)
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float M;
      const float s = weigh_row(um + r, ul + r, slices, P * RT, &M);
      if (lane == 0) {
        rowm[r] = M;
        rowl[r] = s;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      float x = 0.f;
#pragma unroll 8
      for (int sl = 0; sl < slices; ++sl) {
        const int i = sl * P * RT + r;
        x = fmaf(um[i], uacc[i * D + c], x);
      }
      emit<T, D>(a, bg, split, r, c, rowm[r], rowl[r], x);
    }
  }
  if (a.splits == 1) return;

  // the last split of (b, g) to arrive merges the splits' partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.counters + bg, 1u)
           == static_cast<unsigned>(a.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int S = a.splits;
  const long long nrow = static_cast<long long>(gridDim.x) * S * R;
  const long long row0 = static_cast<long long>(bg) * S * R;
  const float* pm = a.part;
  const float* pl = a.part + nrow;
  const float* pa = a.part + 2 * nrow;
  // the splits' m (then weights) and l of every row, loaded at once
  float* w = smem;              // [S][R]
  float* ls = w + S * R;        // [S][R]
  float* lsum_r = ls + S * R;   // [R]
#pragma unroll 4
  for (int i = tid; i < S * R; i += kThreads) {
    w[i] = __ldcg(pm + row0 + i);
    ls[i] = __ldcg(pl + row0 + i);
  }
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float M;
    const float s = weigh_row(w + r, ls + r, S, R, &M);
    if (lane == 0) lsum_r[r] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    float x = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < S; ++sp)
      x = fmaf(w[sp * R + r], __ldcg(pa + (row0 + sp * R + r) * D + c), x);
    store(static_cast<T*>(a.out) + row_offset(a.os, a, bi, g, r) + c,
          x / fmaxf(lsum_r[r], 1e-30f));
  }
  if (tid == 0) a.counters[bg] = 0u;
}

template <typename T, int D, int RT>
int launch_rt(const Args& a, int bg, size_t smem, cudaStream_t s) {
  auto kernel = flash_decode_kernel<T, D, RT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(bg, a.splits), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rt q rows a group keeps: 1, 2, 4 or 8, at most Cfg::RT_MAX
template <typename T, int D, int RT>
int launch_upto(const Args& a, int bg, int rt, size_t smem, cudaStream_t s) {
  if (rt == RT) return launch_rt<T, D, RT>(a, bg, smem, s);
  if constexpr (2 * RT <= Cfg<T, D>::RT_MAX && RT < 8)
    return launch_upto<T, D, 2 * RT>(a, bg, rt, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch_d(const Args& a, int bg, int rt, size_t smem, cudaStream_t s) {
  return launch_upto<T, D, 1>(a, bg, rt, smem, s);
}

template <typename T>
int launch_t(const Args& a, int bg, int d, int rt, size_t smem,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch_d<T, 16>(a, bg, rt, smem, s);
    case 32: return launch_d<T, 32>(a, bg, rt, smem, s);
    case 64: return launch_d<T, 64>(a, bg, rt, smem, s);
    case 128: return launch_d<T, 128>(a, bg, rt, smem, s);
    case 256: return launch_d<T, 256>(a, bg, rt, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


// The C entry of either library: softmax(q k^T * scale) v for q (b, sq,
// h, d) and k, v (b, sk, kvh, d), h % kvh == 0; out (b, sq, h, d).
// `strides` (host memory, 12 values in elements) gives the (b, head, s)
// strides of q, k, v and out; d is contiguous in each.  q, k and v start
// on 16-byte boundaries and their strides are multiples of 16 bytes.  The
// layout is the caller's (kernels/flash_attention.decode_plan), checked
// here only against what the kernel is built for: the keys [key_lo, sk)
// go to splits of `split_keys`; each group of lanes keeps `rt` q rows (1,
// 2, 4 or 8, and rt * its elements of a row at most 64, else the launch
// fails with cudaErrorInvalidValue) and scores every `slices`-th key of
// its split.  With more than one split, `scratch` (scratch_len float32)
// holds the splits' partials and `workspace` (workspace_len int32, zero,
// and left zero) one counter per (b, kv head).  Launches one kernel on
// `stream` and returns its CUDA error code.  `info` (host memory, 4 ints)
// receives the kernels launched, the grid's x and y (b * kvh, splits) and
// the dynamic shared memory of a block in bytes.
template <typename T>
int flash_decode_entry(const void* q, const void* k, const void* v, void* out,
                       const long long* strides, void* scratch,
                       long long scratch_len, void* workspace,
                       long long workspace_len, int b, int h, int kvh, int sq,
                       int sk, int d, int causal, int window, float scale,
                       int key_lo, int split_keys, int rt, int slices,
                       int* info, void* stream) {
  if (info == nullptr || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i) info[i] = 0;
  const int es = static_cast<int>(sizeof(T));
  if (b < 1 || h < 1 || kvh < 1 || h % kvh || sq < 1 || sk < 1
      || window < 0 || key_lo < 0 || key_lo >= sk || split_keys < 1
      || slices < 1 || (rt != 1 && rt != 2 && rt != 4 && rt != 8)
      || (d != 16 && d != 32 && d != 64 && d != 128 && d != 256)
      || !aligned16(q) || !aligned16(k) || !aligned16(v) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if ((strides[i] * es) % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long bg = static_cast<long long>(b) * kvh;
  const long long rows = static_cast<long long>(h / kvh) * sq;
  const int splits = (sk - key_lo + split_keys - 1) / split_keys;
  const long long units = (rows + rt - 1) / rt * slices;
  const long long merge = slices > 1 ? units * rt * (d + 2) + 2 * rows : 0;
  const long long split_merge = splits > 1 ? (2 * splits + 1) * rows : 0;
  const long long smem = 4 * (merge > split_merge ? merge : split_merge);
  const long long need_scratch = splits > 1 ? bg * splits * rows * (d + 2)
                                            : 0;
  const long long need_ws = splits > 1 ? bg : 0;
  if (bg > 0x7fffffffLL || splits > 65535 || rows > 0x7fffffffLL / d
      || smem > 227 * 1024 || scratch_len < need_scratch
      || workspace_len < need_ws
      || (splits > 1 && (scratch == nullptr || workspace == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.part = static_cast<float*>(scratch);
  a.counters = static_cast<unsigned*>(workspace);
  a.kvh = kvh;
  a.rep = h / kvh;
  a.sq = sq;
  a.sk = sk;
  a.R = static_cast<int>(rows);
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.key_lo = key_lo;
  a.split_keys = split_keys;
  a.splits = splits;
  a.slices = slices;
  auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(bg);
  const int err = launch_t<T>(a, n, d, rt, static_cast<size_t>(smem), s);
  if (err == 0) {
    info[0] = 1;
    info[1] = n;
    info[2] = splits;
    info[3] = static_cast<int>(smem);
  }
  return err;
}

}  // namespace
