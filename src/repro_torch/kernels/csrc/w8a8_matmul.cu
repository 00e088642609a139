// W8A8 matmul for Hopper: (m, k) int8 x (k, n) int8 -> int32 -> f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w8a8_matmul.py
// (_w8a8_kernel, built around pl.pallas_call in w8a8_matmul) and computes
// the same function: an exact int32 sum over k, then
// out = (float(acc) * x_scale) * w_scale[n] in float32, each product
// rounded once.  The int32 sum is exact (|sum| < 2^31 for k < 2^17), so
// both regimes below are bit-identical to the plain version's float64
// product and to torch._int_mm; ragged m, k and n are masked in the
// kernels, nothing is padded.  The wrapper's planner picks the regime and
// the row tile by m and hands over the split-k workspace, whose size the
// entry checks; one launch per call either way.
//
// Regime "dp4a" (small m, decode): bound by bytes.  At m = 4 a weight
// byte feeds 4 multiply-adds, far below the ~600 int8 operations per
// byte at which the card stops being bound by its 3.35 TB/s.  A block
// owns 128 columns of an MT-row tile (MT = 4, 8 or 16 by m) and its 8
// warps are k-slices that stream the weight rows a 128-byte line per
// load instruction; each slice takes four k rows at a time,
// transposes the 4 x 4 bytes with __byte_perm so each column's four
// weights share a word, and __dp4a adds four products per instruction
// into int32.  The grid's third dimension splits k so that a phi4
// decode shape launches at least 264 blocks: each split adds its int32
// sums into an (m, n) int32 buffer with atomics (integer sums: the order
// cannot change a bit), and the last block of a tile to arrive (a
// per-tile counter) runs the epilogue on them.  That block leaves the
// sums and its counter zeroed for the next call, so one launch does it
// all.  (A (splits, m, n) buffer summed by the last block costs one L2
// round trip a split in that block, more than the splits save.)
//
// Regime "tc" (large m, prefill): bound by operations (8.25e11 int8
// operations a phi4 layer at m = 4096, 0.417 ms at 1979 TOP/s).  A block
// of two warpgroups owns a 128 x 128 output tile and walks k 128 bytes at
// a time through a ring of three shared-memory stages; each warpgroup
// issues wgmma m64n128k32 s32.s8.s8 on its 64 rows (wgmma.cuh).  Int8
// wgmma takes both operands K-major: the x tile is (m, k) already, the
// weight tile is (k, n).  Both arrive by cp.async two tiles ahead, and
// the block transposes each weight tile in shared memory, 4 x 4 bytes at
// a time with __byte_perm, into the K-major tile the products read.
// (Weights loaded into registers and transposed on the way to shared
// memory left the loads' latency in the loop: on an H100 that design
// took nearly as long with its products removed as with them.)
#include "qmatmul.cuh"

namespace {

using namespace qmm;

// 4 x 4 byte transpose: cols[c] = the bytes of column c of rows[0..3]
__device__ __forceinline__ void transpose4(const int (&rows)[4],
                                           int (&cols)[4]) {
  const int t0 = __byte_perm(rows[0], rows[1], 0x5140);
  const int t1 = __byte_perm(rows[0], rows[1], 0x7362);
  const int t2 = __byte_perm(rows[2], rows[3], 0x5140);
  const int t3 = __byte_perm(rows[2], rows[3], 0x7362);
  cols[0] = __byte_perm(t0, t2, 0x5410);
  cols[1] = __byte_perm(t0, t2, 0x7632);
  cols[2] = __byte_perm(t1, t3, 0x5410);
  cols[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ float dequant(int acc, float x_scale,
                                         float w_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), x_scale), w_scale);
}

// ------------------------------------------------------------------ dp4a

constexpr int kDpLanes = 32;                        // column threads: a warp
constexpr int kDpCols = 4 * kDpLanes;               // 128 columns a block
constexpr int kDpSlices = kThreads / kDpLanes;      // 8 k-slices: the warps

// One slice's walk over k, four k rows a step, into acc[MT][4] (columns
// col .. col + 3).  kFast (k and n multiples of 4, aligned bases): every
// load is one straight-line 32-bit load, out-of-range rows and columns
// read a valid address and are masked to 0, so the unrolled steps'
// loads are all in flight together; else the bytewise masked loads.
template <int MT, bool kFast>
__device__ __forceinline__ void dp4a_walk(int (&acc)[MT][4],
                                          const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          int m, int k, int n, int row0,
                                          int col, int q_begin, int q_end) {
  const bool col_in = col < n;
#pragma unroll 4
  for (int q = q_begin; q < q_end; q += kDpSlices) {
    const int kk = 4 * q;
    int rows[4], cols[4], xr[MT];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = w + static_cast<size_t>(kk + j) * n;
      if constexpr (kFast) {
        const int v =
            __ldg(reinterpret_cast<const int*>(p + (col_in ? col : 0)));
        rows[j] = col_in ? v : 0;
      } else {
        rows[j] = load_word(p + col, kk + j < k ? n - col : 0, false);
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const bool in = row0 + r < m;
      const int8_t* p = x + static_cast<size_t>(in ? row0 + r : row0) * k + kk;
      if constexpr (kFast) {
        const int v = __ldg(reinterpret_cast<const int*>(p));
        xr[r] = in ? v : 0;
      } else {
        xr[r] = load_word(p, in ? k - kk : 0, false);
      }
    }
    transpose4(rows, cols);
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(xr[r], cols[c], acc[r][c]);
  }
}

// A block: 256 threads = 8 warps, one k-slice each; lane l owns columns
// 4 l .. 4 l + 3 of an MT x 128 output tile, so each weight load of a
// warp reads one whole 128-byte line of a row.  The activations are read
// straight from global memory (every lane of a warp reads the same word;
// they are small and stay in L1 and L2), so a block starts streaming
// weights at once and meets its other warps only to sum the slices.
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 4 : MT == 8 ? 2 : 1)
w8a8_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 float* __restrict__ out, int* __restrict__ sums,
                 unsigned* __restrict__ counters, int m, int k, int n,
                 int quads_per_split, bool x_vec, bool w_vec) {
  __shared__ int red[kDpSlices][kDpCols];           // one row's slice sums
  __shared__ bool last;
  const int lane = threadIdx.x % kDpLanes, slice = threadIdx.x / kDpLanes;
  const int col_base = blockIdx.x * kDpCols;
  const int col = col_base + 4 * lane;
  const int row0 = blockIdx.y * MT;
  const int nq = (k + 3) / 4;
  const int q_end = min(nq, static_cast<int>(blockIdx.z + 1) * quads_per_split);

  int acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  const int q_begin = blockIdx.z * quads_per_split + slice;
  if (x_vec && w_vec)
    dp4a_walk<MT, true>(acc, x, w, m, k, n, row0, col, q_begin, q_end);
  else
    dp4a_walk<MT, false>(acc, x, w, m, k, n, row0, col, q_begin, q_end);

  // the 8 slices summed through shared memory, one output row at a time
  const float x_scale = xs[0];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[slice][4 * lane + c] = acc[r][c];
    __syncthreads();
    const int row = row0 + r, c = col_base + threadIdx.x;
    if (threadIdx.x < kDpCols && row < m && c < n) {
      int s = 0;
#pragma unroll
      for (int sl = 0; sl < kDpSlices; ++sl) s += red[sl][threadIdx.x];
      if (gridDim.z == 1)
        out[static_cast<size_t>(row) * n + c] = dequant(s, x_scale, ws[c]);
      else
        atomicAdd(sums + static_cast<size_t>(row) * n + c, s);
    }
    __syncthreads();
  }
  if (gridDim.z == 1) return;

  // split-k: the tile's last split to arrive runs the epilogue on the
  // sums and leaves them zeroed
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < MT * kDpCols; o += kThreads) {
    const int row = row0 + o / kDpCols, c = col_base + o % kDpCols;
    if (row >= m || c >= n) continue;
    int* at = sums + static_cast<size_t>(row) * n + c;
    out[static_cast<size_t>(row) * n + c] =
        dequant(__ldcg(at), x_scale, ws[c]);
    *at = 0;
  }
  if (threadIdx.x == 0) *counter = 0;              // ready for the next call
}

template <int MT>
int launch_dp4a(const int8_t* x, const int8_t* w, const float* xs,
                const float* ws, float* out, int* sums, unsigned* counters,
                int m, int k, int n, int splits, cudaStream_t stream) {
  const int nq = (k + 3) / 4;
  const int per = (nq + splits - 1) / splits;
  if ((nq + per - 1) / per != splits)              // no empty split
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kDpCols - 1) / kDpCols, (m + MT - 1) / MT, splits);
  w8a8_dp4a_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, w, xs, ws, out, sums, counters, m, k, n, per,
      k % 4 == 0 && aligned4(x), n % 4 == 0 && aligned4(w));
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- tensor cores

constexpr int kTM = 128, kTN = 128, kTK = 128;      // tile: m, n, k bytes
constexpr int kStages = 3;
constexpr int kTileBytes = kTM * kTK;               // = kTN * kTK
// rings of x tiles and raw w tiles, one transposed w tile, and slack to
// align the base to 1024: 113 KB, two blocks an SM
constexpr int kTcSmem = (2 * kStages + 1) * kTileBytes + 1024;

// The raw w tile (128 k rows of 128 column bytes) transposed to K-major
// (128 column rows of 128 k bytes, swizzled): thread (warp, lane) reads
// k rows 16 warp .. + 15 of columns 4 lane .. + 3, a word a row, and
// writes each column's 16 k bytes as one chunk.  Each 4 x 4 block is
// transposed after rotating its words by (lane / 2) % 4 bytes, so that
// store c writes column 4 lane + (c + lane / 2) % 4: the eight lanes of a
// quarter-warp then hit eight rows with distinct swizzled chunks, free
// of bank conflicts.
__device__ __forceinline__ void transpose_w(const uint8_t* raw, uint8_t* wk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rot = (lane >> 1) & 3;
  int cols[4][4];                                   // [k group][store]
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int rows[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = *reinterpret_cast<const int*>(
          raw + (16 * warp + 4 * g + j) * 128 + 4 * lane);
      rows[j] = __funnelshift_r(w, w, 8 * rot);
    }
    transpose4(rows, cols[g]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = 4 * lane + ((c + rot) & 3);
    *reinterpret_cast<int4*>(wk + tc::swizzle128(col * 128 + 16 * warp)) =
        make_int4(cols[0][c], cols[1][c], cols[2][c], cols[3][c]);
  }
}

// Tile t's x (K-major already) and raw w arrive in stage t % 3, two tiles
// ahead, by cp.async where the shapes allow (kAsync); after the tensor
// cores finish tile t, the block transposes tile t + 1's w into the one
// K-major w tile.  Two blocks an SM overlap one's transpose with the
// other's products.
template <bool kAsync>
__global__ void __launch_bounds__(256, 2)
w8a8_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  auto xt = [&](int st) { return smem + st * kTileBytes; };
  auto wraw = [&](int st) { return smem + (kStages + st) * kTileBytes; };
  uint8_t* wk = smem + 2 * kStages * kTileBytes;
  const int col0 = blockIdx.x * kTN, row0 = blockIdx.y * kTM;
  const int wg = threadIdx.x / 128;
  const int nk = (k + kTK - 1) / kTK;
  auto fetch = [&](int t) {                 // tile t into stage t % 3
    copy_tile<kAsync>(xt(t % kStages), true, x, m, k, row0, t * kTK);
    copy_tile<kAsync>(wraw(t % kStages), false, w, k, n, t * kTK, col0);
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fetch(0);
  cp_async_commit();
  if (1 < nk) fetch(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  transpose_w(wraw(0), wk);
  tc::fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    tc::fence_regs(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk)
      tc::wgmma_ss_s8_n128(
          acc, tc::desc_b128(xt(kt % kStages) + wg * 64 * 128 + kk * 32),
          tc::desc_b128(wk + kk * 32), 1);
    tc::wgmma_commit();
    // stage (kt + 2) % 3 held tile kt - 1, done with before the last
    // barrier
    if (kt + 2 < nk) fetch(kt + 2);
    cp_async_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    cp_async_wait<1>();                     // tile kt + 1 has landed
    __syncthreads();                        // ... for all; wk is free
    if (kt + 1 < nk) transpose_w(wraw((kt + 1) % kStages), wk);
    tc::fence_proxy_async();
    __syncthreads();
  }

  // acc[4 j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2) of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + (e & 1)
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % 128) / 32;
  const float x_scale = xs[0];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * e2;
    if (row >= m) continue;
    float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col0 + 8 * j + 2 * (lane % 4) + e;
        if (c < n) orow[c] = dequant(acc[4 * j + 2 * e2 + e], x_scale, ws[c]);
      }
  }
}

template <bool kAsync>
int launch_tc_kernel(const int8_t* x, const int8_t* w, const float* xs,
                     const float* ws, float* out, int m, int k, int n,
                     cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_tc_kernel<kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  w8a8_tc_kernel<kAsync><<<grid, 256, kTcSmem, stream>>>(x, w, xs, ws, out,
                                                         m, k, n);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const int8_t* x, const int8_t* w, const float* xs,
              const float* ws, float* out, int m, int k, int n,
              cudaStream_t stream) {
  const auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return k % 16 == 0 && n % 16 == 0 && a16(x) && a16(w)
      ? launch_tc_kernel<true>(x, w, xs, ws, out, m, k, n, stream)
      : launch_tc_kernel<false>(x, w, xs, ws, out, m, k, n, stream);
}

}  // namespace

// x (m, k) int8, w (k, n) int8, x_scale (1,) f32, w_scale (n,) f32 and
// out (m, n) f32, all contiguous on the device.  regime 1 = tensor cores
// (row_tile 128, splits 1); regime 0 = dp4a with row_tile 4, 8 or 16 and
// `splits` k-splits.  When splits > 1, `workspace` holds workspace_len
// zeroed int32: the m * n sums, then one counter per output tile of
// row_tile x 128; it is left zeroed, and a shorter one is refused.
// Launches on `stream` and returns the CUDA error code of the launch.
extern "C" int qappa_w8a8_matmul(const void* x, const void* w,
                                 const void* x_scale, const void* w_scale,
                                 void* out, int m, int k, int n,
                                 void* workspace, long long workspace_len,
                                 int regime, int row_tile, int splits,
                                 void* stream) {
  if (m < 1 || k < 1 || n < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (regime == 1)
    return row_tile == kTM && splits == 1
        ? launch_tc(xq, wq, xs, ws, o, m, k, n, s)
        : static_cast<int>(cudaErrorInvalidValue);
  if (regime != 0 || (row_tile != 4 && row_tile != 8 && row_tile != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sums = static_cast<long long>(m) * n;
  const long long tiles = static_cast<long long>((m + row_tile - 1) / row_tile)
                          * ((n + kDpCols - 1) / kDpCols);
  if (splits > 1 && (workspace == nullptr || workspace_len < sums + tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<int*>(workspace);
  auto* c = reinterpret_cast<unsigned*>(p + (splits > 1 ? sums : 0));
  if (row_tile == 4)
    return launch_dp4a<4>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s);
  if (row_tile == 8)
    return launch_dp4a<8>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s);
  return launch_dp4a<16>(xq, wq, xs, ws, o, p, c, m, k, n, splits, s);
}
