// Sweep aggregate kernel for Hopper (sm_90a): row-stationary mapping +
// energy model per (config, layer), per-segment Kahan sums, six-column
// epilogue.  Replaces the Pallas TPU kernel
// repro/kernels/sweep_kernel.py::_sweep_block_body.
//
// What bounds it: neither bytes nor float operations (both under a
// microsecond at N = 32768, L = 16) but the instructions a cell issues
// (ten integer divisions by values that vary from cell to cell, two IEEE
// float divisions, ~50 float operations that -fmad=false keeps unfused)
// and each block's serial prologue and Kahan pass.  The design:
//
//  * Layer-parallel cells.  A block takes a tile of configs x the layers
//    of one segment (kernels/sweep_kernel.plan sizes it: about TILE_CELLS
//    cells, fewer configs for longer segments) and computes one (config,
//    layer) cell per thread and step, layers fastest, so (N, L) precision
//    columns are read along contiguous rows.  Each cell's total cycles and
//    energy are staged in shared memory; then one thread per config runs
//    the Kahan updates over them in layer order and writes the epilogue,
//    as the TPU kernel computes a (block_n, block_l) tile at once and then
//    sums it per layer.  The grid is one axis over (segment, config tile)
//    for every segment, so ragged segments give blocks of even work.
//  * Exact integer division without the integer-division sequence.  Where
//    a cell's operands are known small (the `fast` test of the cell loop),
//    its integers are carried as exact floats and every quotient comes
//    from the reciprocal, q = trunc(a * rcp(b)), corrected once by the
//    sign of a - q * b and its size against b.  rcp.approx.f32 is within
//    1 ulp (PTX ISA), so for 0 <= a < 5 * 2^20 and 1 <= b < 2^24 (both
//    exact as floats) |a * rcp(b) - a / b| <= (a / b) * 1.5 * 2^-23 < 1,
//    trunc() is floor(a / b) - 1, + 0 or + 1, and the correction lands on
//    floor(a / b).  A cell whose layer and config fields keep every
//    division site in that domain takes this path; any other cell
//    divides with C++ '/' as before.  Both give the same integers.
//  * Each config's values (bandwidth per cycle, SRAM energies, clock, the
//    fields as floats) and each layer's (products, floats, reciprocals of
//    r and s) are computed once a block into 80-byte structures in shared
//    memory, read with 16-byte loads: a cell issues ~216 instructions on
//    the fast path (cuobjdump), most of them the mapping's divisions.  A
//    uniform-column instantiation reads no (N, L) column per cell.
//
// Bit-faithfulness to the x64-free reference policy
// (repro_torch.core.dse_batch._sweep_kernel with exact=False), and to the
// first design of this kernel:
//  * every literal is float, so no expression is promoted to double;
//  * products and sums keep the reference's left-to-right order, and the
//    build passes -fmad=false so no a*b+c is contracted into an FMA;
//  * sqrtf and '/' on floats stay IEEE (no fast-math);
//  * integer mapping is int32 with the reference's products, and the
//    ceiling of positive a/b is (a + b - 1) / b (C++ '/' truncates).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC  (see repro_torch/kernels/_build.py)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLayerRows = 10;  // r s e f c k h w batch (int32), macs (f32)
// shared-memory words per layer (struct Layer) and per config (struct
// Config); kernels/sweep_kernel.py sizes the dynamic shared memory with
// the same numbers
constexpr int kLayerWords = 20;
constexpr int kConfigWords = 20;
constexpr int kMaxSmem = 227 * 1024;
// the fast division's domain (see the header)
constexpr unsigned kFieldMax = 1u << 20;       // layer and PE fields
constexpr unsigned kGlbHalfMax = 1u << 22;     // GLB of 8 MB
constexpr int kDivisorLimit = 1 << 24;         // exact as a float

struct SweepArgs {
  const int* pe_rows;
  const int* pe_cols;
  const int* act_bits;      // (N, 1) or (N, L)
  const int* weight_bits;   // (N, 1) or (N, L)
  const int* glb_kb;
  const int* glb_bits;
  const int* filter_spad;
  const int* psum_spad;
  const int* spad_bits;
  const float* dram_bw_gbps;
  const float* mac_energy_pj;  // (N, 1) or (N, L)
  const float* clock_ghz;
  const float* area_mm2;
  const float* leak_mw;
  // [10 x L layer rows][W x 2 segment bounds][W segment macs (f32 bits)]
  // [W configs per block]
  const int* table;
  float* out;               // (N, 6 * W)
  int n;
  int l;
  int w;
  int ab_wide;              // 1 when the column is (N, L)
  int wb_wide;
  int me_wide;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// floor(a / b) of integers carried as exact floats, 0 <= a < 5 * 2^20 and
// 1 <= b < 2^24, with rb = rcp(b) within 1 ulp: a * rb lies within 1 of
// a / b and below 2^23, where adding 2^23 rounded toward zero truncates
__device__ __forceinline__ float div_floor(float a, float b, float rb) {
  float q = __fadd_rz(a * rb, 0x1p23f) - 0x1p23f;
  const float rem = a - q * b;
  if (rem >= b) q += 1.0f;
  if (rem < 0.0f) q -= 1.0f;
  return q;
}

__device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ bool in_field(int x) {
  return static_cast<unsigned>(x) - 1u < kFieldMax;   // 1 <= x <= 2^20
}

// The integer mapping of a cell, as the floats the energy model takes.
struct Mapping {
  float n_e, n_c, n_k;   // pass groups over e, c and k
  float n_k_glb;         // filter groups the GLB holds
  float ifmap_passes;    // ceil(n_k / filt_res)
  float weight_passes;   // max(1, n_e / w_res)
  float spill;           // max(0, partial-sum spill passes)
};

// The reference's int32 mapping with C++ '/': any input.
__device__ __forceinline__ Mapping mapping_int(
    int r, int s, int e, int f, int c, int k, int pe_rows, int pe_cols,
    int glb_half, int filter_spad, int psum_spad, int filt_bytes_one) {
  const int sets_fit = max(1, pe_rows / r);
  const int c_simult = min(c, sets_fit);
  const int k_simult = max(1, sets_fit / c_simult);
  const int fit_horz = min(e, pe_cols);
  const int n_e = ceil_div(e, fit_horz);
  const int n_c = ceil_div(c, c_simult);
  const int n_k = ceil_div(k, k_simult);
  const int k_fit_glb = max(1, glb_half / filt_bytes_one);
  const int filt_res = max(1, filter_spad / max(1, s));
  const int w_res = min(n_e, filt_res);
  const int spill = psum_spad >= f ? 0 : n_c - 1;
  return {(float)n_e, (float)n_c, (float)n_k,
          (float)ceil_div(k, k_fit_glb), (float)ceil_div(n_k, filt_res),
          (float)max(1, n_e / w_res), (float)max(0, spill)};
}

// One layer's values, staged once a block: each product and float as the
// reference forms it.  80 bytes (five 16-byte words, read as such), so
// neighbouring layers fall in distinct banks.
struct __align__(16) Layer {
  float r, rcp_r, s, rcp_s;
  float e, c, k, f;
  float nb, ifmap, weight, ofmap;     // nb*c*h*w, k*c*r*s, nb*k*e*f
  float two_ofmap, macs, macs3, pad0;
  int f_int, crs, fast, pad1;         // f, c*r*s, r s e c k in the domain
};

// One config's values, staged once a block (80 bytes, as Layer).
struct __align__(16) Config {
  float pe_rows, pe_cols, filter_spad, glb_half;
  float ab, wb, mac_pj, bw_per_cycle;
  float e_spad_pj, e_glb_pj, leak_milli, clk_hz;  // leak_milli: leak * 1e-3f
  int psum_spad, wb_int, fast, pad0;
  float pad1[4];
};

static_assert(sizeof(Layer) == kLayerWords * 4, "Layer is kLayerWords words");
static_assert(sizeof(Config) == kConfigWords * 4,
              "Config is kConfigWords words");

// The reference's mapping on the fast path: every integer an exact float,
// every quotient div_floor's.  Equal to mapping_int where the cell's
// fields lie in the reciprocal division's domain.
__device__ __forceinline__ Mapping mapping_fast(const Layer& ly,
                                                const Config& cf,
                                                int filt_bytes_one) {
  const float fbo = (float)filt_bytes_one;
  const float sets_fit = fmaxf(1.0f, div_floor(cf.pe_rows, ly.r, ly.rcp_r));
  const float c_simult = fminf(ly.c, sets_fit);
  const float rcp_c = rcp_approx(c_simult);
  const float k_simult = fmaxf(1.0f, div_floor(sets_fit, c_simult, rcp_c));
  const float fit_horz = fminf(ly.e, cf.pe_cols);
  const float n_e =
      div_floor(ly.e + fit_horz - 1.0f, fit_horz, rcp_approx(fit_horz));
  const float n_c = div_floor(ly.c + c_simult - 1.0f, c_simult, rcp_c);
  const float n_k =
      div_floor(ly.k + k_simult - 1.0f, k_simult, rcp_approx(k_simult));
  const float k_fit_glb =
      fmaxf(1.0f, div_floor(cf.glb_half, fbo, rcp_approx(fbo)));
  const float filt_res =
      fmaxf(1.0f, div_floor(cf.filter_spad, ly.s, ly.rcp_s));
  const float w_res = fminf(n_e, filt_res);
  return {n_e, n_c, n_k,
          div_floor(ly.k + k_fit_glb - 1.0f, k_fit_glb,
                    rcp_approx(k_fit_glb)),
          div_floor(n_k + filt_res - 1.0f, filt_res, rcp_approx(filt_res)),
          fmaxf(1.0f, div_floor(n_e, w_res, rcp_approx(w_res))),
          cf.psum_spad >= ly.f_int ? 0.0f : n_c - 1.0f};
}

// A cell's total cycles and energy from its mapping, in the reference's
// expressions and order.
__device__ __forceinline__ float2 cell(const Mapping& m, const Layer& ly,
                                       const Config& cf, float ab, float wb,
                                       float mac_pj) {
  const float compute_cycles = ly.nb * m.n_e * m.n_c * m.n_k * ly.s * ly.f;
  const float ifmap_bytes = floorf(ly.ifmap * ab / 8.0f);
  const float weight_bytes = floorf(ly.weight * wb / 8.0f);
  const float ofmap_bytes = floorf(ly.ofmap * ab / 8.0f);
  const float restream = ifmap_bytes <= cf.glb_half ? 1.0f : m.n_k_glb;
  const float dram_bytes = ifmap_bytes * restream + weight_bytes + ofmap_bytes;
  const float dram_elems = ly.ifmap * restream + ly.weight + ly.ofmap;
  const float glb_ifmap = ly.ifmap * m.ifmap_passes;
  const float glb_weight = ly.weight * m.weight_passes;
  const float glb_psum = ly.two_ofmap * m.spill;
  const float glb_elems = 2.0f * dram_elems + glb_ifmap + glb_weight + glb_psum;
  const float mem_cycles = floorf(dram_bytes / cf.bw_per_cycle);
  const float total_cycles = fmaxf(compute_cycles, mem_cycles);
  const float e_spad = ly.macs3 * cf.e_spad_pj;
  const float e_mac = ly.macs * mac_pj;
  const float e_glb = glb_elems * cf.e_glb_pj;
  const float e_leak = cf.leak_milli * (total_cycles / cf.clk_hz) * 1e12f;
  const float energy = e_mac + e_spad + e_glb + e_leak;
  return make_float2(total_cycles, energy);
}

// kWide: some precision column is (N, L); the uniform instantiation reads
// none of them per cell.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
sweep_aggregates_kernel(const SweepArgs a) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int* bounds = a.table + kLayerRows * a.l;
  const int* tiles = bounds + 3 * a.w;

  // this block's segment and tile of configs: the grid runs over every
  // segment's ceil(N / tile) tiles in segment order
  int seg = 0, b = blockIdx.x;
  for (; seg < a.w; ++seg) {
    const int nb = (a.n + tiles[seg] - 1) / tiles[seg];
    if (b < nb) break;
    b -= nb;
  }
  if (seg == a.w) return;
  const int s0 = bounds[2 * seg];
  const int len = bounds[2 * seg + 1] - s0;
  const int tile = tiles[seg];
  const int i0 = b * tile;
  const int cfgs = min(tile, a.n - i0);
  const int stride = len | 1;   // odd: the Kahan pass reads conflict-free

  Config* C = reinterpret_cast<Config*>(smem);            // tile
  Layer* L = reinterpret_cast<Layer*>(C + tile);          // len
  float2* pairs = reinterpret_cast<float2*>(L + len);     // tile x stride

  // the segment's layers, by the block's last threads while its first
  // ones stage the configs
  for (int j = kThreads - 1 - tid; j < len; j += kThreads) {
    const int* t = a.table + s0 + j;
    const int r = t[0], s = t[a.l], e = t[2 * a.l], f = t[3 * a.l];
    const int c = t[4 * a.l], k = t[5 * a.l], h = t[6 * a.l];
    const int w = t[7 * a.l], nb = t[8 * a.l];
    const float macs = __int_as_float(t[9 * a.l]);
    Layer ly;
    ly.r = (float)r;
    ly.rcp_r = rcp_approx((float)r);
    ly.s = (float)s;
    ly.rcp_s = rcp_approx((float)s);
    ly.e = (float)e;
    ly.c = (float)c;
    ly.k = (float)k;
    ly.f = (float)f;
    ly.nb = (float)nb;
    ly.ifmap = (float)(nb * c * h * w);
    ly.weight = (float)(k * c * r * s);
    ly.ofmap = (float)(nb * k * e * f);
    ly.two_ofmap = 2.0f * (float)(nb * k * e * f);
    ly.macs = macs;
    ly.macs3 = 3.0f * macs;
    ly.pad0 = 0.0f;
    ly.f_int = f;
    ly.crs = c * r * s;
    // r s e c k bound the fast division's operands
    ly.fast = in_field(r) && in_field(s) && in_field(e) && in_field(c) &&
              in_field(k);
    ly.pad1 = 0;
    L[j] = ly;
  }
  for (int ci = tid; ci < cfgs; ci += kThreads) {
    const int i = i0 + ci;
    const float clk = a.clock_ghz[i];
    const int glb_half = a.glb_kb[i] * 1024 / 2;
    Config cf;
    cf.pe_rows = (float)a.pe_rows[i];
    cf.pe_cols = (float)a.pe_cols[i];
    cf.filter_spad = (float)a.filter_spad[i];
    cf.glb_half = (float)glb_half;
    cf.ab = a.ab_wide ? 0.0f : (float)a.act_bits[i];
    cf.wb = a.wb_wide ? 0.0f : (float)a.weight_bits[i];
    cf.mac_pj = a.me_wide ? 0.0f : a.mac_energy_pj[i];
    cf.bw_per_cycle = fmaxf(1e-9f, a.dram_bw_gbps[i] / clk);
    cf.e_spad_pj =
        0.035f * sqrtf(fmaxf((float)a.spad_bits[i] / 8192.0f, 0.03125f)) +
        0.015f;
    cf.e_glb_pj =
        0.09f * sqrtf(fmaxf((float)a.glb_bits[i] / 8192.0f, 0.03125f)) +
        0.04f;
    cf.leak_milli = a.leak_mw[i] * 1e-3f;
    cf.clk_hz = clk * 1e9f;
    cf.psum_spad = a.psum_spad[i];
    cf.wb_int = a.wb_wide ? 0 : a.weight_bits[i];
    cf.fast = in_field(a.pe_rows[i]) && in_field(a.pe_cols[i]) &&
              static_cast<unsigned>(a.filter_spad[i]) <= kFieldMax &&
              static_cast<unsigned>(glb_half) <= kGlbHalfMax;
    cf.pad0 = 0;
    C[ci] = cf;
  }
  __syncthreads();

  // cells, layers fastest: thread t takes cells t, t + kThreads, ...
  const int cells = cfgs * len;
  int ci = tid / len, j = tid % len;
  const int dci = kThreads / len, dj = kThreads % len;
  for (int idx = tid; idx < cells; idx += kThreads) {
    const Layer ly = L[j];
    const Config cf = C[ci];
    float ab = cf.ab, wb = cf.wb, mac_pj = cf.mac_pj;
    int wb_int = cf.wb_int;
    if (kWide) {
      const size_t wide = (size_t)(i0 + ci) * a.l + s0 + j;
      if (a.ab_wide) ab = (float)a.act_bits[wide];
      if (a.wb_wide) {
        wb_int = a.weight_bits[wide];
        wb = (float)wb_int;
      }
      if (a.me_wide) mac_pj = a.mac_energy_pj[wide];
    }
    const int filt_bytes_one = max(1, ly.crs * wb_int / 8);
    // r s e c k, pe_rows and pe_cols in [1, 2^20], filter_spad in
    // [0, 2^20], glb_half in [0, 2^22] and filt_bytes_one < 2^24 keep every
    // dividend below 2^20 + 2^22 (the largest: k + k_fit_glb - 1) and
    // every divisor in [1, 2^24): the reciprocal division's domain
    Mapping m;
    if (ly.fast && cf.fast && filt_bytes_one < kDivisorLimit) {
      m = mapping_fast(ly, cf, filt_bytes_one);
    } else {
      const int* t = a.table + s0 + j;
      const int i = i0 + ci;
      m = mapping_int(t[0], t[a.l], t[2 * a.l], t[3 * a.l], t[4 * a.l],
                      t[5 * a.l], a.pe_rows[i], a.pe_cols[i],
                      a.glb_kb[i] * 1024 / 2, a.filter_spad[i], cf.psum_spad,
                      filt_bytes_one);
    }
    pairs[ci * stride + j] = cell(m, ly, cf, ab, wb, mac_pj);
    ci += dci;
    j += dj;
    if (j >= len) {
      j -= len;
      ++ci;
    }
  }
  __syncthreads();

  // Kahan updates in layer order, then the epilogue: one thread a config
  const float seg_macs = __int_as_float(bounds[2 * a.w + seg]);
  for (int ci = tid; ci < cfgs; ci += kThreads) {
    const float2* p = pairs + ci * stride;
    float cyc = 0.0f, cyc_c = 0.0f, en = 0.0f, en_c = 0.0f;
    for (int jj = 0; jj < len; ++jj) {
      const float2 v = p[jj];
      float y = v.x - cyc_c;
      float t = cyc + y;
      cyc_c = (t - cyc) - y;
      cyc = t;
      y = v.y - en_c;
      t = en + y;
      en_c = (t - en) - y;
      en = t;
    }
    const int i = i0 + ci;
    const float clk_hz = C[ci].clk_hz;
    const float latency_s = cyc / clk_hz;
    const float throughput = seg_macs / latency_s / 1e9f;
    float* o = a.out + (size_t)i * 6 * a.w + seg;
    o[0 * a.w] = cyc;
    o[1 * a.w] = en;
    o[2 * a.w] = latency_s;
    o[3 * a.w] = en / 1e12f;
    o[4 * a.w] = throughput;
    o[5 * a.w] = throughput / a.area_mm2[i];
  }
}

}  // namespace

// Launches `blocks` blocks of kThreads threads with `smem` bytes of dynamic
// shared memory, as kernels/sweep_kernel.plan gives them for (n, the
// segment bounds).  `info` (3 ints, host memory) receives the grid
// launched: blocks, threads a block, shared-memory bytes a block; it is set
// only after a successful launch.
extern "C" int qappa_sweep_aggregates(
    const int* pe_rows, const int* pe_cols, const int* act_bits,
    const int* weight_bits, const int* glb_kb, const int* glb_bits,
    const int* filter_spad, const int* psum_spad, const int* spad_bits,
    const float* dram_bw_gbps, const float* mac_energy_pj,
    const float* clock_ghz, const float* area_mm2, const float* leak_mw,
    const int* table, float* out, int n, int l, int w, int blocks, int smem,
    int ab_wide, int wb_wide, int me_wide, int* info, void* stream) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = info[1] = info[2] = 0;
  if (n < 1 || l < 1 || w < 1 || blocks < 1 || smem < 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = ab_wide || wb_wide || me_wide
                          ? sweep_aggregates_kernel<true>
                          : sweep_aggregates_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  SweepArgs a{pe_rows, pe_cols, act_bits, weight_bits, glb_kb, glb_bits,
              filter_spad, psum_spad, spad_bits, dram_bw_gbps,
              mac_energy_pj, clock_ghz, area_mm2, leak_mw, table, out,
              n, l, w, ab_wide, wb_wide, me_wide};
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    info[0] = blocks;
    info[1] = kThreads;
    info[2] = smem;
  }
  return static_cast<int>(err);
}

extern "C" const char* qappa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
