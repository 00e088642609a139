// Serving-fleet simulator for Hopper (sm_90a): every candidate's
// continuous batcher replayed against one request trace, as integer
// iteration stamps.  Replaces no Pallas kernel: it replaces the jitted
// jax.lax.fori_loop of repro/serving/fleet_sim.py::_jax_sim (with
// _simulate_jax around it), which steps every candidate through every
// iteration of the horizon and every slot, one compiled XLA program.
//
// What it computes, per candidate n (step_s[n] seconds an iteration)
// against R requests (arrival_s, service iterations svc = P + G - 1):
// submit[n, r] (-1 if never admitted), comp[n, r] (0 if never admitted)
// and active[n], the iterations below the horizon n_iters with at least
// one busy slot -- the (submit_iter, comp_iter, active_iters) of the
// reference's _simulate_numpy and _simulate_jax.
//
// Design: one thread per candidate walks the requests in FIFO order, as
// the reference's event-driven oracle simulate_fleet_scalar does.  Each
// request takes the slot that frees first (lowest index on ties),
// starts at max(arrival iteration, that slot's free iteration), and a
// start at or past n_iters ends the walk (every later request stays
// unadmitted).  Starts never decrease, so the union of the busy spans
// [start, min(comp, n_iters)) is summed on the fly.  The walk is
// O(R * n_slots) a candidate whatever the horizon, where the jax loop is
// O(n_iters * n_slots) (n_iters reaches 10^5 at small step_s).  The
// reference's tests pin that this walk gives the vectorized simulator's
// stamps bit for bit (tests/test_serving_fleet.py).
//
//  * The arrival iteration ceil(arrival_s[r] / step_s[n]) is computed
//    here in double: '/' on doubles is IEEE round-to-nearest (no
//    fast-math in the build) and ceil is exact, so it equals numpy's
//    float64 value bit for bit.  The wrapper checks the int32 horizon on
//    the host from max(arrival_s) / min(step_s), which division's
//    monotonicity makes the largest of these values.
//  * Slot free times live in registers for n_slots <= kMaxRegSlots: the
//    kernel is instantiated for 1, 2, 4, 8 and 16 register slots, the
//    unused ones held at LLONG_MAX so the arg-min never takes them, and
//    every slot access is unrolled so no array spills to local memory.
//    Above kMaxRegSlots the free times live in a workspace the wrapper
//    allocates, (n_slots, N) int64, read along candidates.
//  * Stamps are written as int64 (R, N) columns, so a warp's stores of
//    one request are contiguous; the wrapper transposes them to (N, R) on
//    the card.  A variant that wrote (N, R) rows directly (strided
//    stores) was measured and dropped: at N = 2^20, R = 48 it took
//    4.81 ms against the column kernel's 0.37 ms plus 0.73 ms of
//    transposes (chip_smoke.py's fleet_timing, H100 80GB HBM3 at 700 W;
//    PERF.md keeps both layouts' readings).
//
// What bounds it on an H100: the bytes it writes, ~16 * N * R (two int64
// stamps a request and candidate), at 3.35 TB/s -- 7.7 us at N = 32768,
// R = 48 -- against N * R * n_slots compare-selects at the CUDA cores'
// 33.5 T operations/s (the 67 TFLOP/s float32 rate, an FMA counted as
// two): 0.38 us at n_slots 8.  One thread a candidate at N = 32768 fills
// 128 blocks of 256 threads, one partial wave, so each thread's serial
// walk (R requests, one double division and n_slots compares each) sets
// the time: 0.021 ms, 2.7x the byte bound; at N = 2^20, 1.5x it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC  (see repro_torch/kernels/_build.py)

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the most slots a thread keeps in registers (kernels/fleet_sim.py's
// MAX_REGISTER_SLOTS)
constexpr int kMaxRegSlots = 16;

struct FleetArgs {
  const double* step_s;     // (N,)
  const double* arrival_s;  // (R,) sorted ascending
  const long long* svc;     // (R,) >= 1
  long long* submit;        // (R, N)
  long long* comp;          // (R, N)
  long long* active;        // (N,)
  long long* free_ws;       // (n_slots, N), workspace path only
  int n;
  int r;
  int n_slots;
  long long n_iters;
};

// One candidate's FIFO walk.  kSlots > 0: free times in registers (the
// first n_slots of kSlots live); kSlots == 0: free times in free_ws.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
fleet_sim_kernel(const FleetArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const double step = a.step_s[i];
  long long f[kSlots > 0 ? kSlots : 1];
  if constexpr (kSlots > 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) f[s] = s < a.n_slots ? 0 : LLONG_MAX;
  } else {
    for (int s = 0; s < a.n_slots; ++s) a.free_ws[(size_t)s * a.n + i] = 0;
  }
  long long cur_s = -1, cur_e = -1, act = 0;
  bool admitting = true;
  for (int j = 0; j < a.r; ++j) {
    long long sub = -1, cm = 0;
    if (admitting) {
      long long mn;
      int slot = 0;
      if constexpr (kSlots > 0) {
        mn = f[0];
#pragma unroll
        for (int s = 1; s < kSlots; ++s) {
          if (f[s] < mn) {
            mn = f[s];
            slot = s;
          }
        }
      } else {
        mn = a.free_ws[i];
        for (int s = 1; s < a.n_slots; ++s) {
          const long long v = a.free_ws[(size_t)s * a.n + i];
          if (v < mn) {
            mn = v;
            slot = s;
          }
        }
      }
      const long long arrive =
          static_cast<long long>(ceil(__ldg(a.arrival_s + j) / step));
      const long long start = arrive > mn ? arrive : mn;
      if (start >= a.n_iters) {
        admitting = false;
      } else {
        sub = start;
        cm = start + __ldg(a.svc + j);
        if constexpr (kSlots > 0) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (s == slot) f[s] = cm;
        } else {
          a.free_ws[(size_t)slot * a.n + i] = cm;
        }
        const long long end = cm < a.n_iters ? cm : a.n_iters;
        if (start > cur_e) {
          if (cur_e > cur_s) act += cur_e - cur_s;
          cur_s = start;
          cur_e = end;
        } else if (end > cur_e) {
          cur_e = end;
        }
      }
    }
    const size_t o = (size_t)j * a.n + i;
    a.submit[o] = sub;
    a.comp[o] = cm;
  }
  if (cur_e > cur_s) act += cur_e - cur_s;
  a.active[i] = act;
}

}  // namespace

// Launches ceil(n / kThreads) blocks of kThreads threads, the kernel
// instantiated for the fewest register slots >= n_slots (or the workspace
// path above kMaxRegSlots, where free_ws must hold n_slots * n int64).
// `info` (3 ints, host memory) receives the launch: blocks, threads a
// block, register slots (0 = workspace); it is set only after a
// successful launch.
extern "C" int qappa_fleet_sim(const double* step_s, const double* arrival_s,
                               const long long* svc, long long* submit,
                               long long* comp, long long* active,
                               long long* free_ws, int n, int r, int n_slots,
                               long long n_iters, int* info, void* stream) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = info[1] = info[2] = 0;
  if (n < 1 || r < 1 || n_slots < 1 || n_iters < 1 || n_iters >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots > kMaxRegSlots && free_ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FleetArgs a{step_s,  arrival_s, svc, submit,  comp,
                    active,  free_ws,   n,   r,       n_slots,
                    n_iters};
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  int slots;
  if (n_slots <= 1) {
    slots = 1;
    fleet_sim_kernel<1><<<blocks, kThreads, 0, st>>>(a);
  } else if (n_slots <= 2) {
    slots = 2;
    fleet_sim_kernel<2><<<blocks, kThreads, 0, st>>>(a);
  } else if (n_slots <= 4) {
    slots = 4;
    fleet_sim_kernel<4><<<blocks, kThreads, 0, st>>>(a);
  } else if (n_slots <= 8) {
    slots = 8;
    fleet_sim_kernel<8><<<blocks, kThreads, 0, st>>>(a);
  } else if (n_slots <= kMaxRegSlots) {
    slots = kMaxRegSlots;
    fleet_sim_kernel<kMaxRegSlots><<<blocks, kThreads, 0, st>>>(a);
  } else {
    slots = 0;
    fleet_sim_kernel<0><<<blocks, kThreads, 0, st>>>(a);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    info[0] = blocks;
    info[1] = kThreads;
    info[2] = slots;
  }
  return static_cast<int>(err);
}

extern "C" const char* qappa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
