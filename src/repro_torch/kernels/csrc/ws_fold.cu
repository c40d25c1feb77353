// The WS fold tables of a generated scenario batch
// (repro_torch.sim.scenarios.pack_scenarios, repro_torch.kernels.ws_fold).
//
// Replaces no Pallas kernel. It replaces the host numpy build of the same
// tables on the generated-scenario path, repro.sim.rounds
// .ws_fold_tables_batch (src/repro/sim/rounds.py; the port's copy is
// repro_torch.sim.rounds.ws_fold_tables_batch, which the trace-driven pack
// and the generated pack's plain backend, kernel="torch", still run).
// Every lane of a generated batch shares one dense time axis,
// so the (lane x point) tables are one regular grid of work, and the host
// built it on one core through a (W, P, N) float64 share array and three
// copies of it, then copied the tables to the card. Here the tables are
// built where the round step reads them, straight into the pack dtype.
//
// For lane w, point p (lease L, level C) and the share line
// s(v) = min(v, C) (FB) or max(v - C, 0) (FLB-NUB) of the demand v:
//   * integral[w, p] = sum_i s(v[w, i]) * width_i, with width_i =
//     max(min(t[i + 1], T) - min(t[i], T), 0) and t[N] = T (the horizon);
//   * at_tick[w, p, k] = v[w, b(k)] with b(k) = upper_bound(t, k L) - 1
//     (numpy's wrap of -1 to N - 1 included), the demand at each lease
//     boundary;
//   * winmax[w, p, k] = max(s(v[w, b(k)]), s(v[w, i]) for the interior
//     points i (t[i] < T) whose window index min(t[i] // L, NT - 1) is k),
//     where // is numpy's float64 floor_divide (fmod-based, snapped to the
//     nearest integer), not floor(t / L);
//   * entries past n_win = max(ceil(T / L), 1) are 0.
// Arithmetic is float64 and rounded once at the store, as the host's
// astype rounds. With integer demands and levels every share is an
// integer and every width a multiple of the step (the last one an integer
// horizon less a step), so the integral is a sum of integers below 2^53,
// exact in any order; the maxima and gathers are exact. The tables are
// then the host's bit for bit.
//
// What bounds it: bytes. At the Monte-Carlo cell's shape (256 lanes, 4032
// steps, 16 points, L 3600 s, NT 337) it writes 22.1 MB of float64 tables
// and reads a 4 MB float32 demand block once: about 8 us at 3.35 TB/s.
// The work per byte is a few comparisons, and the window geometry (the
// searches over the time axis) is shared by every lane. On one H100 it
// takes about 61 us, float64 or float32 alike: the time is the latency of
// each thread's chain of dependent loads (the searches, then a lane's
// points one after another), not the bytes. Loading the 8 lanes' points
// side by side (80 registers, two waves of blocks) took 101 us, and 82 us
// held to 64 registers; 4 or 16 lanes a block and 128-thread blocks took
// 64-115 us.
//
// What the design does about it:
//   * a block per (point, 8 lanes): the block finds each window's boundary
//     index and interior range once, in registers, and applies them to its
//     8 demand rows, so the searches (over the 32 KB time axis, L1-resident)
//     cost one eighth of a block per lane, and the 16 points' blocks of one
//     lane read its row through L2;
//   * threads stride over the windows, so neighbouring threads store
//     neighbouring table entries (coalesced stores, the bytes that bind);
//     a window's interior range starts where the next thread's window
//     ends, handed over by one warp shuffle;
//   * the integral is a strided pass over the row with one float64
//     accumulator per lane and a block reduction in a fixed tree order, so
//     repeated launches give the same bits;
//   * nothing is staged through shared memory but the reduction's partials,
//     and the kernel allocates nothing.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 8;   // demand rows per block
constexpr unsigned FULL = 0xffffffffu;

// numpy's float64 floor_divide (npy_divmod): fmod, the exact multiple
// divided by b, the Python sign convention, then snapped to the nearest
// integer. torch's floor division computes the same.
__device__ __forceinline__ double floor_divide(double a, double b) {
  const double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0 && ((b < 0.0) != (mod < 0.0))) div -= 1.0;
  if (div == 0.0) return copysign(0.0, a / b);
  double fd = floor(div);
  if (div - fd > 0.5) fd += 1.0;
  return fd;
}

// The window index of time t, as the host's astype(int64) takes it.
__device__ __forceinline__ long long window_of(double t, double lease) {
  return static_cast<long long>(floor_divide(t, lease));
}

// The first i in [0, n) with t[i] >= x (np.searchsorted, "left").
__device__ __forceinline__ int lower_bound(const double* t, int n, double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first i in [0, n) with t[i] > x (np.searchsorted, "right").
__device__ __forceinline__ int upper_bound(const double* t, int n, double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first interior point (of the m) whose window index is at least k:
// the searchsorted of k L is where floor division puts it up to rounding,
// and the index is monotone in t, so a step or two either way finds it.
__device__ __forceinline__ int window_start(const double* t, int m,
                                            double lease, int k) {
  int j = lower_bound(t, m, static_cast<double>(k) * lease);
  while (j > 0 && window_of(t[j - 1], lease) >= k) --j;
  while (j < m && window_of(t[j], lease) < k) ++j;
  return j;
}

template <typename V, typename O>
__global__ void __launch_bounds__(THREADS)
ws_fold_kernel(int n_lanes, int n, int n_pts, int nt, int flb,
               double duration, const double* __restrict__ times,
               const V* __restrict__ values,
               const double* __restrict__ leases,
               const double* __restrict__ levels, O* __restrict__ integral,
               O* __restrict__ winmax, O* __restrict__ at_tick) {
  __shared__ double parts[LANES][WARPS];
  const int p = blockIdx.y;
  const int w0 = blockIdx.x * LANES;
  const int lanes = min(LANES, n_lanes - w0);
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const double lease = leases[p], level = levels[p];
  auto share = [&](double v) {
    return flb ? fmax(v - level, 0.0) : fmin(v, level);
  };

  // 1. The integral: a strided pass, one accumulator per lane.
  double acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = 0.0;
  for (int i = tid; i < n; i += THREADS) {
    const double t = times[i];
    const double edge = fmin(i + 1 < n ? times[i + 1] : duration, duration);
    const double width = fmax(edge - fmin(t, duration), 0.0);
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (l < lanes)
        acc[l] += share(static_cast<double>(
                      values[static_cast<size_t>(w0 + l) * n + i])) * width;
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    double a = acc[l];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
    if (wl == 0) parts[l][warp] = a;
  }
  __syncthreads();
  if (tid < lanes) {
    double a = 0.0;
    for (int k = 0; k < WARPS; ++k) a += parts[tid][k];
    integral[static_cast<size_t>(w0 + tid) * n_pts + p] = static_cast<O>(a);
  }

  // 2. The windows. The interior points are a prefix of the sorted axis.
  const int m = lower_bound(times, n, duration);
  const long long c = static_cast<long long>(ceil(duration / lease));
  const long long n_win = c > 1 ? c : 1;
  for (int base = 0; base < nt; base += THREADS) {
    const int k = base + tid;
    const int s0 = k < nt ? window_start(times, m, lease, k) : m;
    int s1 = __shfl_down_sync(FULL, s0, 1);
    if (wl == 31) s1 = k + 1 < nt ? window_start(times, m, lease, k + 1) : m;
    if (k >= nt) continue;
    int b = upper_bound(times, n, static_cast<double>(k) * lease) - 1;
    if (b < 0) b += n;
    const bool live = k <= n_win;
    for (int l = 0; l < lanes; ++l) {
      const V* row = values + static_cast<size_t>(w0 + l) * n;
      const double at = static_cast<double>(row[b]);
      double mx = share(at);
      for (int i = s0; i < s1; ++i)
        mx = fmax(mx, share(static_cast<double>(row[i])));
      const size_t o = (static_cast<size_t>(w0 + l) * n_pts + p) * nt + k;
      winmax[o] = live ? static_cast<O>(mx) : O(0);
      at_tick[o] = live ? static_cast<O>(at) : O(0);
    }
  }
}

template <typename V, typename O>
cudaError_t launch(int n_lanes, int n, int n_pts, int nt, int flb,
                   double duration, const void* times, const void* values,
                   const void* leases, const void* levels, void* integral,
                   void* winmax, void* at_tick, cudaStream_t stream) {
  const dim3 grid((n_lanes + LANES - 1) / LANES, n_pts);
  ws_fold_kernel<V, O><<<grid, THREADS, 0, stream>>>(
      n_lanes, n, n_pts, nt, flb, duration,
      static_cast<const double*>(times), static_cast<const V*>(values),
      static_cast<const double*>(leases), static_cast<const double*>(levels),
      static_cast<O*>(integral), static_cast<O*>(winmax),
      static_cast<O*>(at_tick));
  return cudaGetLastError();
}

}  // namespace

// One batch: times (n) float64, sorted; values (n_lanes, n) float32
// (values_f64 = 0) or float64; leases and levels (n_pts) float64; policy
// 0 = FB, 1 = FLB-NUB; outputs integral (n_lanes, n_pts) and winmax,
// at_tick (n_lanes, n_pts, nt) in float32 (out_f64 = 0) or float64.
// Returns the cudaError_t of the launch.
extern "C" int ws_fold_run(int values_f64, int out_f64, int policy,
                           int n_lanes, int n, int n_pts, int nt,
                           double duration, const void* times,
                           const void* values, const void* leases,
                           const void* levels, void* integral, void* winmax,
                           void* at_tick, void* stream) {
  if (n_lanes <= 0 || n <= 0 || n_pts <= 0 || nt <= 0 || n_pts > 65535 ||
      (policy != 0 && policy != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int flb = policy;
#define WS_FOLD_LAUNCH(V, O)                                                \
  launch<V, O>(n_lanes, n, n_pts, nt, flb, duration, times, values, leases, \
               levels, integral, winmax, at_tick, st)
  cudaError_t err;
  if (values_f64)
    err = out_f64 ? WS_FOLD_LAUNCH(double, double)
                  : WS_FOLD_LAUNCH(double, float);
  else
    err = out_f64 ? WS_FOLD_LAUNCH(float, double)
                  : WS_FOLD_LAUNCH(float, float);
#undef WS_FOLD_LAUNCH
  return (int)err;
}

extern "C" const char* ws_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
