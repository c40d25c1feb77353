// Fused outer step of the event-rounds engine (repro_torch.sim.rounds).
//
// Replaces the Pallas kernel repro.kernels.round_step.chunk_step of the JAX
// package (src/repro/kernels/round_step.py:165, body _chunk_kernel :143,
// which runs repro.sim.rounds._chunk_core). One launch advances every
// (point x trace) lane by one outer step: stable compaction of the done
// window slots, admission of the next job-table rows into the freed tail,
// the power-of-two kill classes, then `compact_every` event rounds (next-
// event horizon, retroactive starts, exact completions, `ff_passes`
// first-fit passes, the section 5.1 size-class kills for FB or the section
// 5.2 U/V/G adjustment at ticks for FLB-NUB). Packed state in, packed state
// out, in the layout of repro_torch.kernels.round_step (sc: 20 scalars,
// win: 7 x K rows).
//
// What bounds it: neither bytes nor operations. A lane moves a few KB and
// does a few thousand flops per round; the time is the serial chain of
// block-wide reductions and scans a round needs (each waits on the one
// before it: the horizon mins, the fresh-submit sum, the completion folds,
// the class sums and threshold suffix scan, two first-fit passes of a scan
// plus a sum each, the post-action queue sums), i.e. latency.
//
// What the design does about it:
//   * one thread block per lane, one thread per window slot (K = 192 FB,
//     96 FLB), so every lane-parallel step is one instruction per thread
//     and the lanes of a sweep run on separate SMs;
//   * a slot's window row lives in registers for the whole chunk and only
//     the compaction goes through shared memory; the loop scalars live in
//     registers too, replicated in every thread: each reduction ends with
//     every thread holding the same result, so no broadcast is needed;
//   * reductions are warp shuffles plus one pass over at most 32 warp
//     partials; the 16 kill-class sums are shared-memory atomics, exact
//     because every size is an integer-valued float.
// Running the whole outer loop inside one launch (instead of one launch per
// outer step) is the next step and is not done here.
//
// Exactness: every value a decision reads is a sum of integer-valued floats
// (sizes, counts, flags), exact in any order, and every time is one IEEE
// add, so the state equals the plain PyTorch version bit for bit except the
// three order-dependent integrals (turn_sum, exec_sum, node_seconds). Build
// without fast math and with -fmad=false, so no product is fused into a sum.
//
// Scope: the engine's default batch == 1 (the contended-stretch coalescer
// runs on the plain version); no fault tables.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SC_T = 0, SC_OWNED = 1, SC_POOL = 2, SC_USED = 3,
              SC_HAS_QUEUE = 4, SC_WSV = 5, SC_ALLOC_PREV = 6,
              SC_RISE_I = 7, SC_NEXT_ROW = 8, SC_ACC0 = 9;
// Accumulators, in repro_torch.sim.rounds.ACC_KEYS order.
enum { A_COMPLETED = 0, A_TURN, A_EXEC, A_KILLS, A_NODE_S, A_PEAK,
       A_PBJ_ADJ, A_ADJ, A_WOVF, A_ROUNDS, A_COAL, N_ACC };
constexpr int SC_SIZE = SC_ACC0 + N_ACC;
constexpr int WIN_ROWS = 7;
constexpr int KILL_CLASSES = 16;
constexpr int MAX_WARPS = 32;
constexpr int MAX_RED = 4;          // values reduced together at most
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T mn(T a, T b) {
  return b < a ? b : a;
}
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return a < b ? b : a;
}

__device__ __forceinline__ float ffloor(float x) { return floorf(x); }
__device__ __forceinline__ double ffloor(double x) { return ::floor(x); }
__device__ __forceinline__ float fceil(float x) { return ceilf(x); }
__device__ __forceinline__ double fceil(double x) { return ::ceil(x); }

struct OpSum {
  template <typename T> __device__ T operator()(T a, T b) const {
    return a + b;
  }
};
struct OpMin {
  template <typename T> __device__ T operator()(T a, T b) const {
    return mn(a, b);
  }
};
struct OpMax {
  template <typename T> __device__ T operator()(T a, T b) const {
    return mx(a, b);
  }
};

// Shared scratch of one block.
template <typename T> struct Scratch {
  T red[MAX_RED * MAX_WARPS];   // per-warp partials of a reduction
  T scan[MAX_WARPS];            // per-warp totals of a scan
  T cls[KILL_CLASSES];          // kill-class sums
  int iscan[MAX_WARPS];         // per-warp totals of an int scan
};

// Reduce M values over the block; every thread returns with the results.
// The partials are combined in the same order in every thread.
template <int M, typename T, typename Op>
__device__ __forceinline__ void block_reduce(T (&v)[M], Op op,
                                             Scratch<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T x = v[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(FULL, x, o));
    v[m] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) s.red[m * MAX_WARPS + warp] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T x = s.red[m * MAX_WARPS];
    for (int w = 1; w < nw; ++w) x = op(x, s.red[m * MAX_WARPS + w]);
    v[m] = x;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T block_sum1(T x, Scratch<T>& s) {
  T v[1] = {x};
  block_reduce<1>(v, OpSum(), s);
  return v[0];
}

// Inclusive prefix sum over slots in thread order; `total` gets the sum.
template <typename T>
__device__ __forceinline__ T block_scan(T x, T& total, Scratch<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s.scan[warp] = x;
  __syncthreads();
  T off = 0, tot = 0;
  for (int w = 0; w < nw; ++w) {
    T p = s.scan[w];
    if (w < warp) off += p;
    tot += p;
  }
  __syncthreads();
  total = tot;
  return x + off;
}

__device__ __forceinline__ int block_scan_int(int x, int& total,
                                              int* iscan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) iscan[warp] = x;
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < nw; ++w) {
    int p = iscan[w];
    if (w < warp) off += p;
    tot += p;
  }
  __syncthreads();
  total = tot;
  return x + off;
}

// ceil(log2(max(size, 1))) clipped to [0, KILL_CLASSES - 1], from integer
// bits: sizes are integers, and log2 near a power of two may round the
// other way. ceil(log2(s)) == ceil(log2(ceil(s))) for s >= 1.
template <typename T> __device__ __forceinline__ int size_class(T size) {
  T s = mx(size, T(1));
  if (s >= T(1u << 30)) return KILL_CLASSES - 1;
  unsigned n = (unsigned)fceil(s);
  int c = n <= 1u ? 0 : 32 - __clz(n - 1u);
  return c < KILL_CLASSES ? c : KILL_CLASSES - 1;
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One slot's window row, held in the registers of its thread.
template <typename T> struct Slot {
  T sub, sz, rt, st, en;
  bool run, done, valid;
  int cls;
};

// Vectorized section 6.5.2 first-fit: `passes` filtered-prefix rounds over
// the queued slots. Returns this slot's start flag; `free` ends reduced by
// every start (same in every thread).
template <typename T>
__device__ __forceinline__ bool first_fit(T& free, bool queued, T sz,
                                          int passes, Scratch<T>& s) {
  bool started = false;
  for (int p = 0; p < passes; ++p) {
    const bool cand = queued && !started && sz <= free;
    const T x = cand ? sz : T(0);
    T total;
    const T prefix = block_scan(x, total, s) - x;
    const bool start = cand && (prefix + sz <= free);
    free = free - block_sum1(start ? sz : T(0), s);
    started = started || start;
  }
  return started;
}

template <typename T, bool FB>
__global__ void chunk_kernel(int K, int Jp, int NR, int NT, int rounds,
                             int ff_passes, double duration,
                             const T* __restrict__ jobs_all,
                             const T* __restrict__ rises_all,
                             const T* __restrict__ wstab_all,
                             const T* __restrict__ prm_all,
                             const T* __restrict__ sc_in,
                             const T* __restrict__ win_in,
                             T* __restrict__ sc_out,
                             T* __restrict__ win_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Scratch<T>& s = *reinterpret_cast<Scratch<T>*>(smem_raw);
  T* cmp = reinterpret_cast<T*>(smem_raw + sizeof(Scratch<T>));  // 6 x K

  const int n = blockIdx.x;
  const int i = threadIdx.x;
  const T inf = T(INFINITY);
  const T dur = T(duration);
  const int n_prm = FB ? 2 : 6;
  const T* jobs = jobs_all + (size_t)n * 3 * Jp;
  const T* rise_t = rises_all + (size_t)n * 2 * NR;
  const T* rise_v = rise_t + NR;
  const T* winmax = wstab_all + (size_t)n * 2 * NT;
  const T* at_tick = winmax + NT;
  const T* prm = prm_all + (size_t)n * n_prm;
  const T* sc = sc_in + (size_t)n * SC_SIZE;
  const T* win = win_in + (size_t)n * WIN_ROWS * K;

  const T L = prm[0];
  T C = 0, B = 0, lb_ws = 0, U = 0, V = 0, G = 0;
  if (FB) {
    C = prm[1];
  } else {
    B = prm[1]; lb_ws = prm[2]; U = prm[3]; V = prm[4]; G = prm[5];
  }

  // Loop scalars, replicated in every thread.
  T t = sc[SC_T], owned = sc[SC_OWNED], pool = sc[SC_POOL],
    used = sc[SC_USED], wsv = sc[SC_WSV], alloc_prev = sc[SC_ALLOC_PREV];
  bool has_queue = sc[SC_HAS_QUEUE] > T(0);
  int rise_i = (int)sc[SC_RISE_I];
  int next_row = (int)sc[SC_NEXT_ROW];
  T acc[N_ACC];
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) acc[a] = sc[SC_ACC0 + a];

  Slot<T> w;
  w.valid = i < K;
  if (w.valid) {
    w.sub = win[0 * K + i]; w.sz = win[1 * K + i]; w.rt = win[2 * K + i];
    w.run = win[3 * K + i] > T(0); w.done = win[4 * K + i] > T(0);
    w.st = win[5 * K + i]; w.en = win[6 * K + i];
  } else {
    w.sub = inf; w.sz = 0; w.rt = 0; w.run = false; w.done = false;
    w.st = 0; w.en = 0;
  }

  // --- stable compaction of the done slots: kept slots move to the head
  // in slot order, the tail takes the fills, then reads the next rows.
  const bool keep = w.valid && !w.done;
  int n_keep;
  const int pos = block_scan_int(keep ? 1 : 0, n_keep, s.iscan) - 1;
  if (keep) {
    cmp[0 * K + pos] = w.sub; cmp[1 * K + pos] = w.sz;
    cmp[2 * K + pos] = w.rt; cmp[3 * K + pos] = w.run ? T(1) : T(0);
    cmp[4 * K + pos] = w.st; cmp[5 * K + pos] = w.en;
  }
  __syncthreads();
  // Slice start clamped into [0, Jp - K] like a dynamic slice: once the
  // table is exhausted, admitted slots read the +inf pad block.
  const int adm = min(max(next_row - n_keep, 0), Jp - K);
  if (w.valid) {
    if (i < n_keep) {
      w.sub = cmp[0 * K + i]; w.sz = cmp[1 * K + i]; w.rt = cmp[2 * K + i];
      w.run = cmp[3 * K + i] > T(0); w.st = cmp[4 * K + i];
      w.en = cmp[5 * K + i];
    } else {
      w.sub = jobs[adm + i]; w.sz = jobs[Jp + adm + i];
      w.rt = jobs[2 * Jp + adm + i];
      w.run = false; w.st = 0; w.en = 0;
    }
    w.done = false;
  }
  next_row = min(next_row + (K - n_keep), Jp);
  const T row_sub = jobs[min(next_row, Jp - 1)];
  w.cls = size_class(w.sz);

  for (int r = 0; r < rounds; ++r) {
    const bool active = t < dur;
    // --- the next event horizon.
    T mins[2] = {(w.valid && w.sub > t) ? w.sub : inf,
                 w.run ? w.en : inf};
    block_reduce<2>(mins, OpMin(), s);
    const T row_next = row_sub > t ? row_sub : inf;
    const T next_sub = mn(mins[0], row_next);
    const T k_next = ffloor(t / L) + T(1);
    const T t_tick = k_next * L;
    T b0 = mn(t_tick, mn(row_next, dur));
    if (FB) b0 = mn(b0, rise_t[clampi(rise_i, NR)]);
    b0 = mn(b0, has_queue ? mins[1] : inf);
    const bool fresh = w.valid && w.sub > t && w.sub <= b0;
    T sum_new = block_sum1(fresh ? w.sz : T(0), s);
    T min_new[1] = {fresh ? w.sz : inf};
    block_reduce<1>(min_new, OpMin(), s);
    T free = owned - used;
    const bool skip_ok = !has_queue && (sum_new <= free);
    const bool unbounded = skip_ok || (has_queue && (min_new[0] > free));
    T b = unbounded ? b0 : mn(b0, next_sub);
    b = active ? b : t;
    // --- exact interval integration of the policy-owned share.
    acc[A_NODE_S] = acc[A_NODE_S] + alloc_prev * mx(b - t, T(0));
    // --- retroactive starts at exact submit times.
    if (w.valid && w.sub > t && w.sub <= b && !w.run && !w.done && skip_ok) {
      w.run = true; w.st = w.sub; w.en = w.sub + w.rt;
    }
    // --- exact completions.
    const bool completing = w.run && w.en <= b;
    if (completing) { w.run = false; w.done = true; }
    T folds[4] = {completing ? T(1) : T(0),
                  completing ? w.en - w.sub : T(0),
                  completing ? w.en - w.st : T(0),
                  w.run ? w.sz : T(0)};
    block_reduce<4>(folds, OpSum(), s);
    acc[A_COMPLETED] = acc[A_COMPLETED] + folds[0];
    acc[A_TURN] = acc[A_TURN] + folds[1];
    acc[A_EXEC] = acc[A_EXEC] + folds[2];
    used = folds[3];
    // --- policy actions at b.
    bool queued = w.valid && w.sub <= b && !w.run && !w.done;
    const bool is_tick = t_tick <= b;
    const int win_i = clampi((int)mn(k_next, T(NT - 1)), NT);
    if (FB) {
      const int ri = clampi(rise_i, NR);
      const bool rised = rise_t[ri] <= b;
      if (rised) { wsv = rise_v[ri]; rise_i += 1; }
    }
    if (is_tick) wsv = at_tick[win_i];
    bool starts;
    T integrand, peak_cand, pbj_ev;
    if (FB) {
      const T ws_t = mn(wsv, C);
      const T need = mx(owned - (C - ws_t), T(0));
      free = owned - used;
      const T kill_need = mn(mx(need - free, T(0)), used);
      // Section 5.1 kill selection: smallest class first, newest arrival
      // first inside the threshold class, until kill_need nodes free.
      if (i < KILL_CLASSES) s.cls[i] = T(0);
      __syncthreads();
      if (w.run) atomicAdd(&s.cls[w.cls], w.sz);
      __syncthreads();
      int thresh = 0;
      T below = 0, below_thr = 0;
      bool found = false;
      for (int c = 0; c < KILL_CLASSES; ++c) {
        const T cs = s.cls[c];
        if (!found && below + cs >= kill_need) {
          thresh = c; below_thr = below; found = true;
        }
        below = below + cs;
      }
      if (!found) below_thr = T(0);   // argmax of all-False is class 0
      __syncthreads();
      const bool kill_all = w.run && w.cls < thresh;
      const T rem_need = mx(kill_need - below_thr, T(0));
      const bool in_thr = w.run && w.cls == thresh;
      const T thr_sz = in_thr ? w.sz : T(0);
      T thr_total;
      const T incl = block_scan(thr_sz, thr_total, s);
      const T rev_prefix = thr_total - incl;   // sum over later slots
      const bool killed =
          kill_need > T(0) && (kill_all || (in_thr && rev_prefix < rem_need));
      if (killed) w.run = false;
      T kk[2] = {killed ? w.sz : T(0), killed ? T(1) : T(0)};
      block_reduce<2>(kk, OpSum(), s);
      used = used - kk[0];
      acc[A_KILLS] = acc[A_KILLS] + kk[1];
      owned = owned - need;
      const T idle = mx(C - ws_t - owned, T(0));
      const T grant = is_tick ? idle : T(0);
      owned = owned + grant;
      pbj_ev = (grant > T(0) ? T(1) : T(0)) + (need > T(0) ? T(1) : T(0));
      free = owned - used;
      starts = first_fit(free, queued, w.sz, ff_passes, s);
      if (starts) w.run = true;
      peak_cand = mn(owned + winmax[win_i], C);
      integrand = owned;
    } else {
      const T pool_ws = mn(wsv, lb_ws);
      const T pool_idle = mx(B - pool_ws - pool, T(0));
      const T grant = is_tick ? pool_idle : T(0);
      owned = owned + grant;
      pool = pool + grant;
      free = owned - used;
      const bool st1 = first_fit(free, queued, w.sz, ff_passes, s);
      if (st1) w.run = true;
      queued = queued && !st1;
      T dd[2] = {st1 ? w.sz : T(0), queued ? w.sz : T(0)};
      block_reduce<2>(dd, OpSum(), s);
      T big[1] = {queued ? w.sz : T(0)};
      block_reduce<1>(big, OpMax(), s);
      used = used + dd[0];
      const T demand = dd[1], biggest = big[0];
      const T ratio = owned > T(0) ? demand / mx(owned, T(1))
                                   : (demand > T(0) ? inf : T(0));
      free = owned - used;
      const T dr1 = mx(demand - owned, T(0));
      const T dr2 = mx(biggest - free, T(0));
      const T req = (is_tick && ratio > U) ? dr1
                    : ((is_tick && biggest > owned) ? dr2 : T(0));
      const T rss = (is_tick && ratio < V && req == T(0))
                        ? ffloor(G * mx(free, T(0))) : T(0);
      owned = owned + req - rss;
      pool = mn(pool, owned);
      pbj_ev = (req > T(0) ? T(1) : T(0)) + (rss > T(0) ? T(1) : T(0));
      free = owned - used;
      const bool st2 = first_fit(free, queued, w.sz, ff_passes, s);
      if (st2) w.run = true;
      starts = st1 || st2;
      const T leased = B + mx(owned - pool, T(0));
      peak_cand = leased + winmax[win_i];
      integrand = leased;
    }
    acc[A_PEAK] = mx(acc[A_PEAK], is_tick ? peak_cand : -inf);
    acc[A_PBJ_ADJ] = acc[A_PBJ_ADJ] + pbj_ev;
    acc[A_ADJ] = acc[A_ADJ] + pbj_ev;
    if (starts) { w.st = b; w.en = b + w.rt; }
    // Queue and usage from the post-action slot state (kills re-queue).
    T post[2] = {(w.valid && w.sub <= b && !w.run && !w.done) ? T(1) : T(0),
                 w.run ? w.sz : T(0)};
    block_reduce<2>(post, OpSum(), s);
    has_queue = post[0] > T(0);
    used = post[1];
    acc[A_WOVF] = acc[A_WOVF] + ((active && row_sub <= b) ? T(1) : T(0));
    acc[A_ROUNDS] = acc[A_ROUNDS] + (active ? T(1) : T(0));
    t = b;
    alloc_prev = integrand;
  }

  T* sco = sc_out + (size_t)n * SC_SIZE;
  if (i == 0) {
    sco[SC_T] = t; sco[SC_OWNED] = owned; sco[SC_POOL] = pool;
    sco[SC_USED] = used; sco[SC_HAS_QUEUE] = has_queue ? T(1) : T(0);
    sco[SC_WSV] = wsv; sco[SC_ALLOC_PREV] = alloc_prev;
    sco[SC_RISE_I] = T(rise_i); sco[SC_NEXT_ROW] = T(next_row);
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) sco[SC_ACC0 + a] = acc[a];
  }
  if (w.valid) {
    T* wo = win_out + (size_t)n * WIN_ROWS * K;
    wo[0 * K + i] = w.sub; wo[1 * K + i] = w.sz; wo[2 * K + i] = w.rt;
    wo[3 * K + i] = w.run ? T(1) : T(0); wo[4 * K + i] = w.done ? T(1) : T(0);
    wo[5 * K + i] = w.st; wo[6 * K + i] = w.en;
  }
}

template <typename T, bool FB>
cudaError_t launch(int n_lanes, int K, int Jp, int NR, int NT, int rounds,
                   int ff_passes, double duration, const void* jobs,
                   const void* rises, const void* wstab, const void* prm,
                   const void* sc_in, const void* win_in, void* sc_out,
                   void* win_out, cudaStream_t stream) {
  const int threads = ((K + 31) / 32) * 32;
  const size_t smem = sizeof(Scratch<T>) + 6 * (size_t)K * sizeof(T);
  chunk_kernel<T, FB><<<n_lanes, threads, smem, stream>>>(
      K, Jp, NR, NT, rounds, ff_passes, duration,
      static_cast<const T*>(jobs), static_cast<const T*>(rises),
      static_cast<const T*>(wstab), static_cast<const T*>(prm),
      static_cast<const T*>(sc_in), static_cast<const T*>(win_in),
      static_cast<T*>(sc_out), static_cast<T*>(win_out));
  return cudaGetLastError();
}

// Cost probe for the serial chain: `steps` dependent block-wide sums (the
// reduction every stage of chunk_kernel is built from, two barriers each)
// in `gridDim.x` blocks of `blockDim.x` threads. Timed at two step counts,
// the difference gives the cost of one barrier at the lanes' block shape.
template <typename T>
__global__ void chain_probe_kernel(int steps, T* __restrict__ out) {
  __shared__ Scratch<T> s;
  T x = T(threadIdx.x & 7);
  for (int k = 0; k < steps; ++k) x = mn(block_sum1(x, s), T(threadIdx.x & 7));
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = x;
}

}  // namespace

// policy: 0 = FB, 1 = FLB-NUB. Returns the cudaError_t of the launch.
extern "C" int round_step_chunk(int policy, int is_f64, int n_lanes, int K,
                                int Jp, int NR, int NT, int rounds,
                                int ff_passes, double duration,
                                const void* jobs, const void* rises,
                                const void* wstab, const void* prm,
                                const void* sc_in, const void* win_in,
                                void* sc_out, void* win_out, void* stream) {
  if (n_lanes <= 0) return 0;
  if (K < 1 || K > 1024 || Jp < K || NR < 1 || NT < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_f64) {
    e = policy == 0
            ? launch<double, true>(n_lanes, K, Jp, NR, NT, rounds, ff_passes,
                                   duration, jobs, rises, wstab, prm, sc_in,
                                   win_in, sc_out, win_out, st)
            : launch<double, false>(n_lanes, K, Jp, NR, NT, rounds,
                                    ff_passes, duration, jobs, rises, wstab,
                                    prm, sc_in, win_in, sc_out, win_out, st);
  } else {
    e = policy == 0
            ? launch<float, true>(n_lanes, K, Jp, NR, NT, rounds, ff_passes,
                                  duration, jobs, rises, wstab, prm, sc_in,
                                  win_in, sc_out, win_out, st)
            : launch<float, false>(n_lanes, K, Jp, NR, NT, rounds, ff_passes,
                                   duration, jobs, rises, wstab, prm, sc_in,
                                   win_in, sc_out, win_out, st);
  }
  return (int)e;
}

// `threads` must be a multiple of 32 in [32, 1024]; `out` holds
// n_blocks * threads values of the dtype.
extern "C" int round_step_chain_probe(int is_f64, int n_blocks, int threads,
                                      int steps, void* out, void* stream) {
  if (n_blocks <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    chain_probe_kernel<double><<<n_blocks, threads, 0, st>>>(
        steps, static_cast<double*>(out));
  else
    chain_probe_kernel<float><<<n_blocks, threads, 0, st>>>(
        steps, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* round_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
