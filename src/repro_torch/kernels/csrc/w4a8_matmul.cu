// W4A8-pow2 matmul for Hopper: (m, k) int8 activations x (k/2, n) int8
// weights holding two 4-bit power-of-two codes per byte -> f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w4a8_matmul.py
// (_w4a8_kernel with _decode_pow2_block, built around pl.pallas_call in
// w4a8_matmul).  Code layout as there: packed row p holds k = 2p in the
// low nibble and k = 2p + 1 in the high one; bit 3 is the sign and bits
// 0-2 the exponent e of the value +-2^(e - 7).  The TPU kernel decodes to
// float32 and sums in float32; both regimes below sum the integers
// +-(x << e) exactly in int32 (the paper's LightPE-1 shift-add datapath:
// |sum| <= 128 * 128 * k < 2^31 for k < 2^17) and apply 2^-7 in the
// epilogue, out = ((float(acc) * 2^-7) * x_scale) * w_scale[n].  That is
// bit-identical to the plain version's exact float64 sum, and differs
// from the TPU kernel's float32 sum only by that sum's rounding.  The
// wrapper's planner picks the regime by m, and for split-k the row tile
// and the split count, and hands over the split-k workspace, whose size
// the entry checks; one launch a call.
//
// A weight takes 16 values in [-128, 128], and +128 does not fit a
// signed byte.  So both regimes decode the codes into unsigned magnitude
// bytes 2^e (1..128), split into a positive and a negative set, pos and
// neg, and multiply x (signed) by each: the negative set meets ~x =
// -x - 1 (x = -128 has no int8 negation) in the same accumulator, and
// each column's sum of its negative magnitudes, kept once for all rows,
// adds the -1 back: x.pos + (~x).neg + sum(neg) = x.pos - x.neg, exactly.
// decode_pow2 turns a column's four codes into its pos and neg words:
// one PRMT gathers the four codes into a selector, one PRMT turns the
// four exponents into the magnitude bytes, one PRMT with the sign nibbles
// and a rotate give the bytes' sign mask.
//
// Regime "split-k" (m < TC_MIN_M, decode).  At m = 4 a packed weight byte
// feeds 8 multiply-adds, so the integer instructions that decode the
// codes and sum the products weigh as much as the bytes (half those of
// W8A8).  The block is W8A8's dp4a block (qmatmul.cuh): 8 warps are
// k-slices, lane l owns columns 4 l .. 4 l + 3 of a 128-column tile, so
// a warp's load reads a 128-byte line of a packed row; a step takes 4 k
// (two packed rows: pairs of codes are never cut).  A slice walks its
// steps in batches of 32 / MT whose loads are all issued first: the
// weights, and one activation word a lane, read straight from global
// memory and handed to the products by __shfl_sync (no shared staging,
// no barrier in the loop).  The grid's third dimension splits k as
// W8A8's does, the splits adding int32 sums by atomics in the stream's
// zeroed workspace, the last block of a tile running the epilogue and
// re-zeroing.  The codes are decoded in registers and dp4a.s32.u32 takes
// x.pos and (~x).neg: two dp4a per 4 multiply-adds, the least with 8-bit
// operands; on an H100 the dp4a, the decode and the load latency of each
// block's few batches share what it takes (PERF.md).
//
// Regime "tc" (m >= TC_MIN_M, prefill): bound by operations (3.54 ms of
// int8 operations a llama-3.2-vision layer at m = 4096 at 1979 TOP/s;
// below 129 rows the grid has only n / 128 blocks, so split-k serves m
// up to TC_MIN_M, where the two meet on a phi4 layer).
// W8A8's tensor-core block: two warpgroups own a 128 x 128 output tile
// and walk k 128 at a time through a ring of three cp.async stages, two
// tiles ahead; the packed weight tile is 64 packed rows x 128 column
// bytes, half of W8A8's.  In place of W8A8's transpose, the block decodes
// each packed tile (decode_tile) into two K-major u8 tiles, pos and neg,
// 128 column rows of 128 k bytes in the 128-byte swizzle the wgmma
// descriptors read: decode_pow2 gives a column's four consecutive k as
// one word, so the decode is the transpose.  Each k32 step issues two
// wgmma m64n128k32 s32.s8.u8 into one accumulator: x.pos with both
// operands in shared memory, then (~x).neg with ~x in registers, each
// thread loading its fragment of the x tile and inverting it (64 s32
// accumulators a thread; two accumulators, x.pos and x.neg, would take
// 128).  The decode keeps each column's sum(neg) in registers; the block
// adds the columns' sums in shared memory once and into the accumulators
// before the epilogue, the split-k kernel's Pow2Dequant.  Two blocks an
// SM (105 KB of shared memory each) overlap one's decode with the
// other's products.  Ragged m, k (k = 2 mod 4 too) and n are masked:
// zero x past k meets the zero bytes' +1 codes.  Where k or n is not a
// multiple of 16 or a base is not 16-byte aligned, the tiles are loaded
// and stored bytewise instead of by cp.async.
//
// Designs tried: a tiled CUDA-core design (a 256-entry table in shared
// memory, __dp2a, 32 columns a block, k unsplit) took 2.1 times as long
// as split-k at m = 4096 and 1.7-1.9 times at m = 17-128 on an H100, so
// split-k served every m until the tc regime (PERF.md).  In the tc
// regime, ~x as a second shared-memory A tile that the decode stage
// wrote (121 KB, one block an SM) took 2.550 ms a phi4-mini layer at
// m = 4096 against 2.012 for ~x from registers on an H100, so ~x comes
// from registers.
#include "qmatmul.cuh"

namespace {

using namespace qmm;

// the magnitudes 2^0 .. 2^7 as the bytes 0-7 of {kMagHi, kMagLo}
constexpr unsigned kMagLo = 0x08040201u, kMagHi = 0x80402010u;

// PRMT in its generic mode: byte i of the result is byte s[4i+2:4i] of
// {b, a}, or that byte's sign bit replicated over 8 bits when s[4i+3]
// is set
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// c + the dot product of a's four signed bytes with b's four unsigned
__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Column c's four codes (k = 4q .. 4q + 3: byte c of packed rows 2q and
// 2q + 1) as two words of magnitude bytes 2^e in k order: pos holds the
// positive codes' and neg the negative codes', 0 elsewhere.
__device__ __forceinline__ void decode_pow2(unsigned w0, unsigned w1, int c,
                                            unsigned& pos, unsigned& neg) {
  const unsigned sel = prmt(w0, w1, 0x40u + 0x11u * c);     // 4 code nibbles
  const unsigned mag = prmt(kMagLo, kMagHi, sel & 0x7777u);
  // 0xff where the code is negative, 0x80 where positive; the rotate puts
  // each byte's own bit 7 (set in all) at bit 0 of the next one, so the
  // product of the two keeps 0xff and clears 0x80
  const unsigned sgn = prmt(0x80808080u, 0x80808080u, sel);
  const unsigned rot = __funnelshift_l(sgn, sgn, 1);
  pos = mag & ~(sgn & rot);
  neg = mag & sgn & rot;
}

// One slice's walk over its quads q_begin, q_begin + 8, ... < q_end
// (4 k a step) into acc[MT][4] (columns col .. col + 3) and neg_sum[4]
// (each column's sum of negative magnitudes), in batches of U = 32 / MT
// steps whose loads are all issued before the first product: 2 U weight
// words a lane, and one activation word a lane (row lane / U, step
// lane % U), which the products take by __shfl_sync.  A step past q_end
// reads x = 0, and then any weight bytes add 0 (x.pos + (~x).neg + sum(neg)
// = x.(pos - neg)), so the weights' addresses are only kept in range.
// kFast (k and n multiples of 4, aligned bases): straight 32-bit loads;
// else bytewise masked ones.
template <int MT, bool kFast>
__device__ __forceinline__ void splitk_walk(int (&acc)[MT][4],
                                            int (&neg_sum)[4],
                                            const int8_t* __restrict__ x,
                                            const int8_t* __restrict__ wp,
                                            int m, int k, int n, int row0,
                                            int col, int lane, int q_begin,
                                            int q_end) {
  constexpr int U = kSplitLanes / MT;               // steps a batch
  const int kp = k / 2;
  const int xrow = row0 + lane / U, xstep = lane % U;
  const int8_t* xp = x + static_cast<size_t>(xrow < m ? xrow : row0) * k;
  const int8_t* wc = wp + (col < n ? col : 0);
#pragma unroll 1
  for (int qb = q_begin; qb < q_end; qb += U * kSplitSlices) {
    unsigned w[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = qb + u * kSplitSlices;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kFast) {
          w[u][j] = __ldg(reinterpret_cast<const unsigned*>(
              wc + static_cast<size_t>(2 * (q < q_end ? q : qb) + j) * n));
        } else {
          const int row = 2 * q + j;
          w[u][j] = static_cast<unsigned>(load_word(
              wp + static_cast<size_t>(row) * n + col,
              q < q_end && row < kp ? n - col : 0, false));
        }
      }
    }
    const int xq = qb + xstep * kSplitSlices;
    const bool x_in = xrow < m && xq < q_end;
    int xw;
    if constexpr (kFast) {
      xw = __ldg(reinterpret_cast<const int*>(xp + 4 * (x_in ? xq : qb)));
      xw = x_in ? xw : 0;
    } else {
      xw = load_word(xp + 4 * xq, x_in ? k - 4 * xq : 0, false);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int xr[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r)
        xr[r] = __shfl_sync(0xffffffffu, xw, r * U + u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned pos, neg;
        decode_pow2(w[u][0], w[u][1], c, pos, neg);
        neg_sum[c] = dp4a_su(0x01010101, neg, neg_sum[c]);
#pragma unroll
        for (int r = 0; r < MT; ++r)
          acc[r][c] = dp4a_su(~xr[r], neg, dp4a_su(xr[r], pos, acc[r][c]));
      }
    }
  }
}

// out = ((float(acc) * 2^-7) * x_scale) * w_scale[col], each product
// rounded once
struct Pow2Dequant {
  float x_scale;
  const float* __restrict__ ws;
  __device__ __forceinline__ float operator()(int acc, int col) const {
    const float v = __fmul_rn(__int2float_rn(acc), 0.0078125f);  // 2^-7
    return __fmul_rn(__fmul_rn(v, x_scale), ws[col]);
  }
};

// A block: 256 threads = 8 warps, one k-slice each, over an MT x 128
// output tile; split z of the grid walks quads [z per, (z + 1) per).
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 3 : MT == 8 ? 2 : 1)
w4a8_splitk_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ wp,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int* __restrict__ sums,
                   unsigned* __restrict__ counters, int m, int k, int n,
                   int quads_per_split, bool x_vec, bool w_vec) {
  const int lane = threadIdx.x % kSplitLanes;
  const int slice = threadIdx.x / kSplitLanes;
  const int col_base = blockIdx.x * kSplitCols;
  const int col = col_base + 4 * lane;
  const int row0 = blockIdx.y * MT;
  const int nq = (k + 3) / 4;
  const int q_end =
      min(nq, static_cast<int>(blockIdx.z + 1) * quads_per_split);

  int acc[MT][4], neg_sum[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    neg_sum[c] = 0;
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r][c] = 0;
  }
  const int q_begin = blockIdx.z * quads_per_split + slice;
  if (x_vec && w_vec)
    splitk_walk<MT, true>(acc, neg_sum, x, wp, m, k, n, row0, col, lane,
                          q_begin, q_end);
  else
    splitk_walk<MT, false>(acc, neg_sum, x, wp, m, k, n, row0, col, lane,
                           q_begin, q_end);
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += neg_sum[c];
  splitk_finish<MT>(acc, out, sums, counters, m, n, row0, col_base,
                    Pow2Dequant{xs[0], ws});
}

template <int MT>
int launch_splitk(const int8_t* x, const int8_t* wp, const float* xs,
                  const float* ws, float* out, int* sums, unsigned* counters,
                  int m, int k, int n, int splits, cudaStream_t stream,
                  int* info) {
  int per;
  const dim3 grid = splitk_grid(m, k, n, MT, splits, &per);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidValue);
  w4a8_splitk_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, wp, xs, ws, out, sums, counters, m, k, n, per,
      k % 4 == 0 && aligned4(x), n % 4 == 0 && aligned4(wp));
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    info[0] = grid.x;
    info[1] = grid.y;
    info[2] = grid.z;
  }
  return err;
}

// -------------------------------------------------------- tensor cores

constexpr int kTM = 128, kTN = 128, kTK = 128;      // tile: m, n, k
constexpr int kTKP = kTK / 2;                       // packed rows a tile
constexpr int kStages = 3;
constexpr int kXBytes = kTM * kTK;                  // an x tile
constexpr int kMagBytes = kTN * kTK;                // a pos or neg tile
constexpr int kWBytes = kTKP * kTN;                 // a packed tile
// rings of x tiles and packed tiles, the pos and neg tiles, and slack to
// align the base to 1024: 105 KB (two blocks an SM)
constexpr int kTcSmem =
    kStages * (kXBytes + kWBytes) + 2 * kMagBytes + 1024;

// The packed tile (64 packed rows of 128 column bytes) decoded to the
// K-major pos and neg tiles (128 column rows of 128 k bytes, swizzled):
// thread (warp, lane) reads packed rows 8 warp .. + 7 of columns
// 4 lane .. + 3, a word a row, and writes each column's 16 k bytes (quads
// 4 warp .. + 3) as one chunk of each tile.  Store s writes column
// 4 lane + (s + lane / 2) % 4, so the eight lanes of a quarter-warp hit
// eight rows with distinct swizzled chunks (as W8A8's transpose_w).
// neg_sum[s] gathers that column's negative magnitudes.
__device__ __forceinline__ void decode_tile(const uint8_t* raw, uint8_t* pos,
                                            uint8_t* neg,
                                            int (&neg_sum)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rot = (lane >> 1) & 3;
  unsigned w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = *reinterpret_cast<const unsigned*>(raw + (8 * warp + j) * kTN
                                              + 4 * lane);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = (s + rot) & 3;
    unsigned p[4], q[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      decode_pow2(w[2 * g], w[2 * g + 1], c, p[g], q[g]);
      neg_sum[s] = dp4a_su(0x01010101, q[g], neg_sum[s]);
    }
    const uint32_t off = tc::swizzle128((4 * lane + c) * kTK + 16 * warp);
    *reinterpret_cast<uint4*>(pos + off) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(neg + off) = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// Tile t's x and packed w arrive in stage t % 3, two tiles ahead, by
// cp.async where the shapes allow (kAsync); after the tensor cores finish
// tile t, the block decodes tile t + 1's codes into the pos and neg
// tiles.
template <bool kAsync>
__global__ void __launch_bounds__(256, 2)
w4a8_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int col_neg[kTN];                      // each column's sum(neg)
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  auto xt = [&](int st) { return smem + st * kXBytes; };
  uint8_t* pos = smem + kStages * kXBytes;
  uint8_t* neg = pos + kMagBytes;
  auto wraw = [&](int st) { return neg + kMagBytes + st * kWBytes; };
  const int col0 = blockIdx.x * kTN, row0 = blockIdx.y * kTM;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % 128) / 32;
  const int nk = (k + kTK - 1) / kTK;
  auto fetch = [&](int t) {                 // tile t into stage t % 3
    copy_tile<kAsync>(xt(t % kStages), true, x, m, k, row0, t * kTK);
    copy_tile<kAsync, kTKP>(wraw(t % kStages), false, wp, k / 2, n,
                            t * kTKP, col0);
  };
  int neg_sum[4] = {0, 0, 0, 0};
  auto stage = [&](int t) {
    decode_tile(wraw(t % kStages), pos, neg, neg_sum);
  };
  if (threadIdx.x < kTN) col_neg[threadIdx.x] = 0;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fetch(0);
  cp_async_commit();
  if (1 < nk) fetch(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  stage(0);
  tc::fence_proxy_async();
  __syncthreads();
  // this thread's ~x fragment starts at row lane / 4 of the warp's 16 of
  // its warpgroup's 64, byte 4 (lane % 4) of each 16 k bytes
  const int frag = (wg * 64 + warp * 16 + lane / 4) * kTK + 4 * (lane % 4);
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* xk = xt(kt % kStages);
    uint32_t nx[kTK / 32][4];
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        nx[kk][i] = ~*reinterpret_cast<const uint32_t*>(
            xk + tc::swizzle128(frag + 8 * kTK * (i & 1)
                                + 32 * kk + 16 * (i >> 1)));
    tc::fence_regs(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk) {
      tc::wgmma_ss_s8u8_n128(acc, tc::desc_b128(xk + wg * 64 * kTK + kk * 32),
                             tc::desc_b128(pos + kk * 32), 1);
      tc::wgmma_rs_s8u8_n128(acc, nx[kk], tc::desc_b128(neg + kk * 32), 1);
    }
    tc::wgmma_commit();
    // stage (kt + 2) % 3 held tile kt - 1, done with before the last
    // barrier
    if (kt + 2 < nk) fetch(kt + 2);
    cp_async_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    cp_async_wait<1>();                     // tile kt + 1 has landed
    __syncthreads();                        // ... for all; pos, neg free
    if (kt + 1 < nk) stage(kt + 1);
    tc::fence_proxy_async();
    __syncthreads();
  }

  // the columns' sums of negative magnitudes, over the 8 warps' k chunks
  const int rot = (lane >> 1) & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    atomicAdd(&col_neg[4 * lane + ((s + rot) & 3)], neg_sum[s]);
  __syncthreads();

  // acc[4 j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2) of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + (e & 1)
  const Pow2Dequant epi{xs[0], ws};
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * e2;
    if (row >= m) continue;
    float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        if (col0 + c < n)
          orow[col0 + c] = epi(acc[4 * j + 2 * e2 + e] + col_neg[c], col0 + c);
      }
  }
}

template <bool kAsync>
int launch_tc_kernel(const int8_t* x, const int8_t* wp, const float* xs,
                     const float* ws, float* out, int m, int k, int n,
                     cudaStream_t stream, int* info) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a8_tc_kernel<kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  w4a8_tc_kernel<kAsync><<<grid, 256, kTcSmem, stream>>>(x, wp, xs, ws, out,
                                                         m, k, n);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    info[0] = grid.x;
    info[1] = grid.y;
    info[2] = 1;
  }
  return err;
}

int launch_tc(const int8_t* x, const int8_t* wp, const float* xs,
              const float* ws, float* out, int m, int k, int n,
              cudaStream_t stream, int* info) {
  const auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return k % 16 == 0 && n % 16 == 0 && a16(x) && a16(wp)
      ? launch_tc_kernel<true>(x, wp, xs, ws, out, m, k, n, stream, info)
      : launch_tc_kernel<false>(x, wp, xs, ws, out, m, k, n, stream, info);
}

}  // namespace

// x (m, k) int8 with k even, w_packed (k/2, n) int8, x_scale (1,) f32,
// w_scale (n,) f32 and out (m, n) f32, all contiguous on the device.
// regime 1 = tensor cores (row_tile 128, splits 1); regime 0 = split-k
// with row_tile 4, 8 or 16 output rows a block and `splits` k-splits.
// When splits > 1, `workspace` holds workspace_len zeroed int32: the
// m * n sums, then one counter per output tile of row_tile x 128; it is
// left zeroed, and a shorter one is refused.  `info` (3 ints, host
// memory) receives the grid launched: columns / 128, row tiles, splits;
// all 0 when nothing was.
// Launches on `stream` and returns the CUDA error code of the launch.
extern "C" int qappa_w4a8_matmul(const void* x, const void* w_packed,
                                 const void* x_scale, const void* w_scale,
                                 void* out, int m, int k, int n,
                                 void* workspace, long long workspace_len,
                                 int regime, int row_tile, int splits,
                                 int* info, void* stream) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = info[1] = info[2] = 0;
  if (m < 1 || k < 2 || k % 2 || n < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w_packed);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (regime == 1)
    return row_tile == kTM && splits == 1
        ? launch_tc(xq, wq, xs, ws, o, m, k, n, s, info)
        : static_cast<int>(cudaErrorInvalidValue);
  if (regime != 0 || (row_tile != 4 && row_tile != 8 && row_tile != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sums = static_cast<long long>(m) * n;
  const long long tiles = static_cast<long long>((m + row_tile - 1) / row_tile)
                          * ((n + kSplitCols - 1) / kSplitCols);
  if (splits > 1 && (workspace == nullptr || workspace_len < sums + tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<int*>(workspace);
  auto* c = reinterpret_cast<unsigned*>(p + (splits > 1 ? sums : 0));
  if (row_tile == 4)
    return launch_splitk<4>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s, info);
  if (row_tile == 8)
    return launch_splitk<8>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s, info);
  return launch_splitk<16>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s, info);
}
