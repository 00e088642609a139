// Sweep aggregate kernel for Hopper (sm_90a): row-stationary mapping +
// energy model per (config, layer), per-segment Kahan sums, six-column
// epilogue.  Replaces the Pallas TPU kernel
// repro/kernels/sweep_kernel.py::_sweep_block_body.
//
// One thread per (config, segment) on a (ceil(N / 256), W) grid; each
// thread walks its segment's layers in order with the Kahan state in
// registers.  The block stages the segment's layer fields in shared
// memory (every thread reads the same word: a broadcast).
//
// Bit-faithfulness to the x64-free reference policy
// (repro_torch.core.dse_batch._sweep_kernel with exact=False):
//  * every literal is float, so no expression is promoted to double;
//  * products and sums keep the reference's left-to-right order, and the
//    build passes -fmad=false so no a*b+c is contracted into an FMA;
//  * sqrtf and '/' stay IEEE (no fast-math);
//  * integer mapping is int32 with the reference's products, and the
//    ceiling of positive a/b is (a + b - 1) / b (C++ '/' truncates).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC  (see repro_torch/kernels/_build.py)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableRows = 10;  // r s e f c k h w batch (int32), macs (f32)

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
  const int* table;
  float* out;               // (N, 6 * W)
  int n;
  int l;
  int w;
  int ab_wide;              // 1 when the column is (N, L)
  int wb_wide;
  int me_wide;
};

__device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__global__ void __launch_bounds__(kThreads)
sweep_aggregates_kernel(const SweepArgs a) {
  extern __shared__ int layers[];  // kTableRows x seg_len
  const int seg = blockIdx.y;
  const int* bounds = a.table + kTableRows * a.l;
  const int s0 = bounds[2 * seg];
  const int len = bounds[2 * seg + 1] - s0;
  for (int idx = threadIdx.x; idx < kTableRows * len; idx += blockDim.x) {
    const int row = idx / len;
    layers[idx] = a.table[row * a.l + s0 + idx % len];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const int pe_rows = a.pe_rows[i];
  const int pe_cols = a.pe_cols[i];
  const int glb_half = a.glb_kb[i] * 1024 / 2;
  const int filter_spad = a.filter_spad[i];
  const int psum_spad = a.psum_spad[i];
  const float clk = a.clock_ghz[i];
  const float clk_hz = clk * 1e9f;
  const float leak = a.leak_mw[i];
  const float bw_per_cycle = fmaxf(1e-9f, a.dram_bw_gbps[i] / clk);
  const float e_spad_pj =
      0.035f * sqrtf(fmaxf((float)a.spad_bits[i] / 8192.0f, 0.03125f)) +
      0.015f;
  const float e_glb_pj =
      0.09f * sqrtf(fmaxf((float)a.glb_bits[i] / 8192.0f, 0.03125f)) + 0.04f;
  const size_t wide_row = (size_t)i * a.l + s0;

  float cyc = 0.0f, cyc_c = 0.0f, en = 0.0f, en_c = 0.0f;
  for (int j = 0; j < len; ++j) {
    const int r = layers[0 * len + j];
    const int s = layers[1 * len + j];
    const int e = layers[2 * len + j];
    const int f = layers[3 * len + j];
    const int c = layers[4 * len + j];
    const int k = layers[5 * len + j];
    const int h = layers[6 * len + j];
    const int w = layers[7 * len + j];
    const int nb = layers[8 * len + j];
    const float macs = __int_as_float(layers[9 * len + j]);
    const int ab = a.ab_wide ? a.act_bits[wide_row + j] : a.act_bits[i];
    const int wb = a.wb_wide ? a.weight_bits[wide_row + j] : a.weight_bits[i];
    const float mac_pj =
        a.me_wide ? a.mac_energy_pj[wide_row + j] : a.mac_energy_pj[i];

    // spatial mapping
    const int sets_fit = max(1, pe_rows / r);
    const int c_simult = min(c, sets_fit);
    const int k_simult = max(1, sets_fit / c_simult);
    const int fit_horz = min(e, pe_cols);
    const int n_e = ceil_div(e, fit_horz);
    const int n_c = ceil_div(c, c_simult);
    const int n_k = ceil_div(k, k_simult);
    const float compute_cycles = (float)nb * (float)n_e * (float)n_c *
                                 (float)n_k * (float)s * (float)f;

    // element / byte counts
    const int ifmap_elems = nb * c * h * w;
    const int weight_elems = k * c * r * s;
    const int ofmap_elems = nb * k * e * f;
    const float ifmap_bytes = floorf((float)ifmap_elems * (float)ab / 8.0f);
    const float weight_bytes = floorf((float)weight_elems * (float)wb / 8.0f);
    const float ofmap_bytes = floorf((float)ofmap_elems * (float)ab / 8.0f);
    const int filt_bytes_one = max(1, c * r * s * wb / 8);
    const int k_fit_glb = max(1, glb_half / filt_bytes_one);
    const int n_k_glb = ceil_div(k, k_fit_glb);
    const float restream =
        ifmap_bytes <= (float)glb_half ? 1.0f : (float)n_k_glb;
    const float dram_bytes = ifmap_bytes * restream + weight_bytes + ofmap_bytes;
    const float dram_elems = (float)ifmap_elems * restream +
                             (float)weight_elems + (float)ofmap_elems;

    // GLB traffic in elements
    const int filt_res = max(1, filter_spad / max(1, s));
    const int w_res = min(n_e, filt_res);
    const int spill = psum_spad >= f ? 0 : n_c - 1;
    const float glb_ifmap = (float)ifmap_elems * (float)ceil_div(n_k, filt_res);
    const float glb_weight = (float)weight_elems * (float)max(1, n_e / w_res);
    const float glb_psum = 2.0f * (float)ofmap_elems * (float)max(0, spill);
    const float glb_elems = 2.0f * dram_elems + glb_ifmap + glb_weight + glb_psum;

    // stalls and energy
    const float mem_cycles = floorf(dram_bytes / bw_per_cycle);
    const float total_cycles = fmaxf(compute_cycles, mem_cycles);
    const float e_spad = 3.0f * macs * e_spad_pj;
    const float e_mac = macs * mac_pj;
    const float e_glb = glb_elems * e_glb_pj;
    const float e_leak = leak * 1e-3f * (total_cycles / clk_hz) * 1e12f;
    const float energy = e_mac + e_spad + e_glb + e_leak;

    // Kahan updates in layer order
    float y = total_cycles - cyc_c;
    float t = cyc + y;
    cyc_c = (t - cyc) - y;
    cyc = t;
    y = energy - en_c;
    t = en + y;
    en_c = (t - en) - y;
    en = t;
  }

  const float seg_macs = __int_as_float(bounds[2 * a.w + seg]);
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

}  // namespace

extern "C" int qappa_sweep_aggregates(
    const int* pe_rows, const int* pe_cols, const int* act_bits,
    const int* weight_bits, const int* glb_kb, const int* glb_bits,
    const int* filter_spad, const int* psum_spad, const int* spad_bits,
    const float* dram_bw_gbps, const float* mac_energy_pj,
    const float* clock_ghz, const float* area_mm2, const float* leak_mw,
    const int* table, float* out, int n, int l, int w, int max_seg,
    int ab_wide, int wb_wide, int me_wide, void* stream) {
  SweepArgs a{pe_rows, pe_cols, act_bits, weight_bits, glb_kb, glb_bits,
              filter_spad, psum_spad, spad_bits, dram_bw_gbps,
              mac_energy_pj, clock_ghz, area_mm2, leak_mw, table, out,
              n, l, w, ab_wide, wb_wide, me_wide};
  const dim3 grid((n + kThreads - 1) / kThreads, w);
  const size_t smem = (size_t)kTableRows * max_seg * sizeof(int);
  sweep_aggregates_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qappa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
