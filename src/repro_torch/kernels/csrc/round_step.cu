// Fused outer steps of the event-rounds engine (repro_torch.sim.rounds).
//
// Replaces the Pallas kernel repro.kernels.round_step.chunk_step of the JAX
// package (src/repro/kernels/round_step.py:165, body _chunk_kernel :137,
// which runs repro.sim.rounds._chunk_core) and, on the engine's path, the
// while_loop the JAX package runs around it on the device
// (src/repro/sim/rounds.py:1108-1120). One outer step of a lane: stable
// compaction of the done window slots, admission of the next job-table
// rows into the freed tail, the power-of-two kill classes, then
// `compact_every` event rounds (next-event horizon, retroactive starts,
// exact completions, `ff_passes` first-fit passes, the section 5.1
// size-class kills for FB or the section 5.2 U/V/G adjustment at ticks for
// FLB-NUB). Packed state in, packed state out, in the layout of
// repro_torch.kernels.round_step (sc: 20 scalars, win: 7 x K rows).
//
// Two entries share that step (outer_step):
//   * round_step_run, the engine's path: one launch per policy runs every
//     lane's whole outer loop, each block looping its own lane while
//     (steps < outer_max) & (t < duration), the reference's per-lane
//     while_loop predicate, with the state in registers between steps;
//     it writes the state once at the end, with each lane's step count;
//   * round_step_chunk: one outer step of every lane per launch, which the
//     after-every-chunk comparison with the plain version steps through.
//
// With `batch` > 1 each round also runs the contended-stretch coalescer
// (repro_torch.sim.rounds._coalesce): while a queue existed at the round
// start, up to `batch` completion instants inside the horizon, and the
// queue admissions they allow, are replayed in the one round, which ends
// at the first instant where the closed form could diverge from first-fit.
//
// What bounds it: neither bytes nor operations. A lane moves a few KB and
// does a few thousand flops per round; the time is the serial chain of
// block-wide reductions and scans a round needs (each waits on the one
// before it: the horizon mins, the fresh-submit sum, the completion folds,
// the class sums and threshold suffix scan, two first-fit passes of a scan
// plus a sum each, the post-action queue sums), i.e. latency, times the
// outer steps of the lane that needs the most. Run one step per launch,
// the engine also paid a host round trip per step (a sync on the live
// test, two selects, a launch), several times the kernel's own time; the
// run entry pays one launch and no sync per policy. The coalescer adds
// 2 * batch + 7 barriers to a round whose lane has a queue (batch + 1
// reductions for the instants and the frontier, one scan for the
// admission prefix, one barrier for the started-by buckets, one reduction
// for the divergence instant) and drops the horizon's three reductions
// (6 barriers), which that lane does not need; a lane without a queue
// skips the coalescer whole and runs one paired reduction for its horizon
// instead of three (repro_torch.kernels.round_step.chain_barriers counts
// the first case, an upper bound).
//
// What the design does about it:
//   * one thread block per lane, one thread per window slot (K = 192 FB,
//     96 FLB), so every lane-parallel step is one instruction per thread
//     and the lanes of a sweep run on separate SMs (a paper_grid(128)
//     sweep has 42 lanes per policy: a third of the 132 SMs);
//   * a slot's window row lives in registers for the whole run and only
//     the compaction goes through shared memory; the loop scalars live in
//     registers too, replicated in every thread: each reduction ends with
//     every thread holding the same result, so no broadcast is needed, and
//     the loop's exit test is the same in every thread;
//   * reductions are warp shuffles plus one pass over at most 32 warp
//     partials; the 16 kill-class sums and the coalescer's started-by
//     buckets are shared-memory atomics, exact because every size is an
//     integer-valued float;
//   * `engaged` (active lane with a queue) is a loop scalar, the same in
//     every thread of a block, so a block branches around the coalescer
//     and its barriers without divergence; the coalescer is a template
//     flag, and the batch == 1 instantiation has none of it.
//
// Exactness: every value a decision reads is a sum of integer-valued floats
// (sizes, counts, flags), exact in any order, and every time is one IEEE
// add, so the state equals the plain PyTorch version bit for bit except the
// three order-dependent integrals (turn_sum, exec_sum, node_seconds). The
// coalescer's freed and started masses, admission needs and free-capacity
// estimates are such sums too, and each start or end time one add. Build
// without fast math and with -fmad=false, so no product is fused into a sum.
//
// The run entry does the same arithmetic per step as the chunk entry, so
// its rows equal the per-chunk path's bit for bit.
//
// Scope: any batch <= K; no fault tables.

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
constexpr int MAX_RED = 7;          // values reduced together at most
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

// A sum and a min reduced together in one pass (two barriers).
template <typename T>
__device__ __forceinline__ void block_sum_min(T& sum, T& lo, Scratch<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, o);
    lo = mn(lo, __shfl_xor_sync(FULL, lo, o));
  }
  if (lane == 0) {
    s.red[warp] = sum;
    s.red[MAX_WARPS + warp] = lo;
  }
  __syncthreads();
  T a = s.red[0], b = s.red[MAX_WARPS];
  for (int w = 1; w < nw; ++w) {
    a += s.red[w];
    b = mn(b, s.red[MAX_WARPS + w]);
  }
  sum = a;
  lo = b;
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

// What one lane reads besides its state: its job table, its FB rise
// stops, its WS fold tables and its policy scalars.
template <typename T> struct LaneIn {
  const T *jobs, *rise_t, *rise_v, *winmax, *at_tick;
  T L, C, B, lb_ws, U, V, G;
};

// The loop scalars, replicated in every thread of the lane's block.
template <typename T> struct LaneState {
  T t, owned, pool, used, wsv, alloc_prev;
  bool has_queue;
  int rise_i, next_row;
  T acc[N_ACC];
};

// The static shape of a launch.
struct Dims {
  int K, Jp, NR, NT, rounds, ff_passes, batch;
};

// The block's shared memory: the reduction scratch, the compaction
// buffer (6 x K) and the coalescer's per-instant values (batch each:
// the instants, the cumulative freed mass and the started-by buckets).
template <typename T> struct Shared {
  Scratch<T>* s;
  T *cmp, *tau, *fcum, *hist;
};

template <typename T>
__device__ __forceinline__ Shared<T> shared_of(unsigned char* raw, int K,
                                               int batch) {
  Shared<T> sh;
  sh.s = reinterpret_cast<Scratch<T>*>(raw);
  sh.cmp = reinterpret_cast<T*>(raw + sizeof(Scratch<T>));
  sh.tau = sh.cmp + 6 * K;
  sh.fcum = sh.tau + batch;
  sh.hist = sh.fcum + batch;
  return sh;
}

template <typename T, bool FB>
__device__ __forceinline__ LaneIn<T> lane_in(int n, const Dims& d,
                                             const T* jobs_all,
                                             const T* rises_all,
                                             const T* wstab_all,
                                             const T* prm_all) {
  LaneIn<T> in;
  in.jobs = jobs_all + (size_t)n * 3 * d.Jp;
  in.rise_t = rises_all + (size_t)n * 2 * d.NR;
  in.rise_v = in.rise_t + d.NR;
  in.winmax = wstab_all + (size_t)n * 2 * d.NT;
  in.at_tick = in.winmax + d.NT;
  const T* prm = prm_all + (size_t)n * (FB ? 2 : 6);
  in.L = prm[0];
  in.C = in.B = in.lb_ws = in.U = in.V = in.G = T(0);
  if (FB) {
    in.C = prm[1];
  } else {
    in.B = prm[1]; in.lb_ws = prm[2]; in.U = prm[3]; in.V = prm[4];
    in.G = prm[5];
  }
  return in;
}

// Lane n's packed state into the loop scalars (every thread) and this
// thread's slot.
template <typename T>
__device__ __forceinline__ void load_state(int n, int K, const T* sc_in,
                                           const T* win_in, LaneState<T>& st,
                                           Slot<T>& w) {
  const int i = threadIdx.x;
  const T* sc = sc_in + (size_t)n * SC_SIZE;
  const T* win = win_in + (size_t)n * WIN_ROWS * K;
  st.t = sc[SC_T]; st.owned = sc[SC_OWNED]; st.pool = sc[SC_POOL];
  st.used = sc[SC_USED]; st.wsv = sc[SC_WSV];
  st.alloc_prev = sc[SC_ALLOC_PREV];
  st.has_queue = sc[SC_HAS_QUEUE] > T(0);
  st.rise_i = (int)sc[SC_RISE_I];
  st.next_row = (int)sc[SC_NEXT_ROW];
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) st.acc[a] = sc[SC_ACC0 + a];
  w.valid = i < K;
  if (w.valid) {
    w.sub = win[0 * K + i]; w.sz = win[1 * K + i]; w.rt = win[2 * K + i];
    w.run = win[3 * K + i] > T(0); w.done = win[4 * K + i] > T(0);
    w.st = win[5 * K + i]; w.en = win[6 * K + i];
  } else {
    w.sub = T(INFINITY); w.sz = 0; w.rt = 0; w.run = false; w.done = false;
    w.st = 0; w.en = 0;
  }
  w.cls = 0;
}

template <typename T>
__device__ __forceinline__ void store_state(int n, int K, const LaneState<T>& st,
                                            const Slot<T>& w, T* sc_out,
                                            T* win_out) {
  const int i = threadIdx.x;
  T* sco = sc_out + (size_t)n * SC_SIZE;
  if (i == 0) {
    sco[SC_T] = st.t; sco[SC_OWNED] = st.owned; sco[SC_POOL] = st.pool;
    sco[SC_USED] = st.used; sco[SC_HAS_QUEUE] = st.has_queue ? T(1) : T(0);
    sco[SC_WSV] = st.wsv; sco[SC_ALLOC_PREV] = st.alloc_prev;
    sco[SC_RISE_I] = T(st.rise_i); sco[SC_NEXT_ROW] = T(st.next_row);
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) sco[SC_ACC0 + a] = st.acc[a];
  }
  if (w.valid) {
    T* wo = win_out + (size_t)n * WIN_ROWS * K;
    wo[0 * K + i] = w.sub; wo[1 * K + i] = w.sz; wo[2 * K + i] = w.rt;
    wo[3 * K + i] = w.run ? T(1) : T(0); wo[4 * K + i] = w.done ? T(1) : T(0);
    wo[5 * K + i] = w.st; wo[6 * K + i] = w.en;
  }
}

// One outer step of one lane, the body both entries share: compaction,
// admission, size classes and d.rounds event rounds. Every branch around
// a barrier reads only loop scalars, so it is taken alike in every
// thread of the block.
template <typename T, bool FB, bool COAL>
__device__ __forceinline__ void outer_step(const Dims& d, const LaneIn<T>& in,
                                           T dur, LaneState<T>& st,
                                           Slot<T>& w, const Shared<T>& sh) {
  const int K = d.K, Jp = d.Jp, NR = d.NR, NT = d.NT, rounds = d.rounds,
            ff_passes = d.ff_passes, batch = d.batch;
  Scratch<T>& s = *sh.s;
  T* const cmp = sh.cmp;
  T* const tau = sh.tau;
  T* const fcum = sh.fcum;
  T* const hist = sh.hist;
  const int i = threadIdx.x;
  const T inf = T(INFINITY);
  const T* const jobs = in.jobs;
  const T* const rise_t = in.rise_t;
  const T* const rise_v = in.rise_v;
  const T* const winmax = in.winmax;
  const T* const at_tick = in.at_tick;
  const T L = in.L, C = in.C, B = in.B, lb_ws = in.lb_ws, U = in.U,
          V = in.V, G = in.G;
  T& t = st.t;
  T& owned = st.owned;
  T& pool = st.pool;
  T& used = st.used;
  T& wsv = st.wsv;
  T& alloc_prev = st.alloc_prev;
  bool& has_queue = st.has_queue;
  int& rise_i = st.rise_i;
  int& next_row = st.next_row;
  T* const acc = st.acc;

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
    const T row_next = row_sub > t ? row_sub : inf;
    const T k_next = ffloor(t / L) + T(1);
    const T t_tick = k_next * L;
    T b0 = mn(t_tick, mn(row_next, dur));
    if (FB) b0 = mn(b0, rise_t[clampi(rise_i, NR)]);
    T free = owned - used;
    // The coalescer's three folds (completions, turnaround, execution),
    // summed with the completion folds below.
    T coal[3] = {T(0), T(0), T(0)};
    T b;
    bool skip_ok;
    if constexpr (!COAL) {
      T mins[2] = {(w.valid && w.sub > t) ? w.sub : inf,
                   w.run ? w.en : inf};
      block_reduce<2>(mins, OpMin(), s);
      const T next_sub = mn(mins[0], row_next);
      b0 = mn(b0, has_queue ? mins[1] : inf);
      const bool fresh = w.valid && w.sub > t && w.sub <= b0;
      T sum_new = block_sum1(fresh ? w.sz : T(0), s);
      T min_new[1] = {fresh ? w.sz : inf};
      block_reduce<1>(min_new, OpMin(), s);
      skip_ok = !has_queue && (sum_new <= free);
      const bool unbounded = skip_ok || (has_queue && (min_new[0] > free));
      b = unbounded ? b0 : mn(b0, next_sub);
      b = active ? b : t;
    } else {
      // With coalescing on, completions never bound the horizon, and
      // with a queue neither do submits: an engaged lane (active, with a
      // queue) takes b0 as it is and needs no reduction for it.
      const T free0 = free;
      const bool engaged = active && has_queue;   // same in every thread
      if (!engaged) {
        const bool fresh = w.valid && w.sub > t && w.sub <= b0;
        T sum_new = fresh ? w.sz : T(0);
        T min_sub = (w.valid && w.sub > t) ? w.sub : inf;
        block_sum_min(sum_new, min_sub, s);
        skip_ok = !has_queue && (sum_new <= free0);
        const bool unbounded = skip_ok || has_queue;
        b = unbounded ? b0 : mn(b0, mn(min_sub, row_next));
        b = active ? b : t;
      } else {
        skip_ok = false;
        b = b0;
        // --- the contended-stretch coalescer (see the header).
        // (1) masked top-k: the next `batch` distinct completion instants
        // inside (t, b), each with the mass it frees, then the frontier.
        if (i < batch) hist[i] = T(0);
        bool avail = w.run && w.en < b;
        T v[1] = {avail ? w.en : inf};
        block_reduce<1>(v, OpMin(), s);
        T tau_j = v[0], cum = T(0);
        for (int j = 0; j < batch; ++j) {
          if (!(tau_j < inf)) {         // nothing left: the rest is empty
            if (i == 0) {
              for (int m = j; m < batch; ++m) {
                tau[m] = inf;
                fcum[m] = cum;
              }
            }
            break;
          }
          const bool take = avail && w.en <= tau_j;
          avail = avail && !take;
          T freed = take ? w.sz : T(0);
          T next = avail ? w.en : inf;
          block_sum_min(freed, next, s);
          cum = cum + freed;
          if (i == 0) { tau[j] = tau_j; fcum[j] = cum; }
          tau_j = next;
        }
        const T frontier = tau_j;
        // (2) prefix-sum admission in slot (= arrival) order: a pending
        // job starts at the first instant whose freed mass covers the
        // pending jobs ahead of it plus itself, or at once (t or its
        // submit) when the free capacity already does.
        const bool pend = w.valid && !w.run && !w.done && w.sub <= b;
        const T psz = pend ? w.sz : T(0);
        T psz_total;
        const T need = (block_scan(psz, psz_total, s) - psz) + w.sz - free0;
        int idx = 0;
        for (int j = 0; j < batch; ++j) idx += need > fcum[j] ? 1 : 0;
        T start_at = inf;
        if (pend && (need <= T(0) || idx < batch))
          start_at = mx(w.sub, need <= T(0) ? t : tau[idx]);
        // A zero-runtime job starting at the round start is left to the
        // tail's first-fit (the divergence instant must stay > t).
        if (w.rt <= T(0) && start_at <= t) start_at = inf;
        // (3) divergence probes. started_by[j], the mass started at or
        // before instant j, is a prefix sum of buckets: a start falls in
        // the bucket of the first instant at or after it.
        if (start_at < inf) {
          int j0 = 0;
          while (j0 < batch && !(start_at <= tau[j0])) ++j0;
          if (j0 < batch) atomicAdd(&hist[j0], w.sz);
        }
        __syncthreads();
        // Leapfrogs: a pending job that fits the (over-estimated) free
        // capacity at an instant before its start, or at its arrival;
        // min_j over fits[i, j] is the reference's column-any form.
        T started = T(0), fprev = T(0), sprev = T(0), net_before = T(0);
        T leap = inf;
        for (int j = 0; j < batch; ++j) {
          const T tj = tau[j], fj = fcum[j];
          started = started + hist[j];
          const T free_at = free0 + fj - started;
          if (pend && w.sub <= tj && start_at > tj && w.sz <= free_at)
            leap = mn(leap, tj);
          if (tj < w.sub)
            net_before = net_before + ((fj - fprev) - (started - sprev));
          fprev = fj;
          sprev = started;
        }
        const T free_arr = free0 + net_before;
        if (pend && w.sub > t && start_at > w.sub && w.sz <= free_arr)
          leap = mn(leap, w.sub);
        // Chain events: a batch-started job ending inside the round.
        T th[2] = {leap, start_at < inf ? start_at + w.rt : inf};
        block_reduce<2>(th, OpMin(), s);
        const T chain = th[1] > t ? th[1] : inf;
        const T theta = mn(mn(th[0], chain), frontier);
        // (4) apply everything strictly before theta.
        const T lim = mn(theta, b);
        const bool cmp_c = w.run && w.en < lim;
        const bool st_c = start_at < lim;
        if (cmp_c) {
          coal[0] = T(1);
          coal[1] = w.en - w.sub;
          coal[2] = w.en - w.st;
          w.run = false;
          w.done = true;
        }
        if (st_c) {
          w.run = true;
          w.st = start_at;
          w.en = start_at + w.rt;
        }
        b = mn(b, theta);
      }
    }
    // --- exact interval integration of the policy-owned share.
    acc[A_NODE_S] = acc[A_NODE_S] + alloc_prev * mx(b - t, T(0));
    // --- retroactive starts at exact submit times.
    if (w.valid && w.sub > t && w.sub <= b && !w.run && !w.done && skip_ok) {
      w.run = true; w.st = w.sub; w.en = w.sub + w.rt;
    }
    // --- exact completions.
    const bool completing = w.run && w.en <= b;
    if (completing) { w.run = false; w.done = true; }
    constexpr int NF = COAL ? 7 : 4;
    T folds[NF];
    folds[0] = completing ? T(1) : T(0);
    folds[1] = completing ? w.en - w.sub : T(0);
    folds[2] = completing ? w.en - w.st : T(0);
    folds[3] = w.run ? w.sz : T(0);
    if constexpr (COAL) {
      folds[NF - 3] = coal[0];
      folds[NF - 2] = coal[1];
      folds[NF - 1] = coal[2];
    }
    block_reduce<NF>(folds, OpSum(), s);
    if constexpr (COAL) {
      // The coalescer's folds land first, as in the plain version.
      acc[A_COMPLETED] = acc[A_COMPLETED] + folds[NF - 3];
      acc[A_TURN] = acc[A_TURN] + folds[NF - 2];
      acc[A_EXEC] = acc[A_EXEC] + folds[NF - 1];
      acc[A_COAL] = acc[A_COAL] + folds[NF - 3];
    }
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
}

template <typename T, bool FB, bool COAL>
__global__ void chunk_kernel(Dims d, double duration,
                             const T* __restrict__ jobs_all,
                             const T* __restrict__ rises_all,
                             const T* __restrict__ wstab_all,
                             const T* __restrict__ prm_all,
                             const T* __restrict__ sc_in,
                             const T* __restrict__ win_in,
                             T* __restrict__ sc_out,
                             T* __restrict__ win_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x;
  const LaneIn<T> in =
      lane_in<T, FB>(n, d, jobs_all, rises_all, wstab_all, prm_all);
  LaneState<T> st;
  Slot<T> w;
  load_state(n, d.K, sc_in, win_in, st, w);
  outer_step<T, FB, COAL>(d, in, T(duration), st, w,
                          shared_of<T>(smem_raw, d.K, d.batch));
  store_state(n, d.K, st, w, sc_out, win_out);
}

// The whole outer loop of lane n in one block: the lane's predicate
// (it < outer_max) & (t < duration), the reference's while_loop test, is
// read from loop scalars that every thread holds alike, so the block
// leaves the loop as one. A lane that fails it keeps its state, as the
// host loop's freeze would. steps[n] gets the lane's outer-step count.
// The compaction buffer is rewritten by the next step only after the
// two barriers of that step's first scan, so its reads are done.
template <typename T, bool FB, bool COAL>
__global__ void run_kernel(Dims d, int outer_max, double duration,
                           const T* __restrict__ jobs_all,
                           const T* __restrict__ rises_all,
                           const T* __restrict__ wstab_all,
                           const T* __restrict__ prm_all,
                           const T* __restrict__ sc_in,
                           const T* __restrict__ win_in,
                           T* __restrict__ sc_out, T* __restrict__ win_out,
                           int* __restrict__ steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x;
  const LaneIn<T> in =
      lane_in<T, FB>(n, d, jobs_all, rises_all, wstab_all, prm_all);
  const Shared<T> sh = shared_of<T>(smem_raw, d.K, d.batch);
  const T dur = T(duration);
  LaneState<T> st;
  Slot<T> w;
  load_state(n, d.K, sc_in, win_in, st, w);
  int it = 0;
  while (it < outer_max && st.t < dur) {
    outer_step<T, FB, COAL>(d, in, dur, st, w, sh);
    ++it;
  }
  store_state(n, d.K, st, w, sc_out, win_out);
  if (threadIdx.x == 0) steps[n] = it;
}

struct LaunchArgs {
  int n_lanes;
  Dims d;
  int outer_max;   // run_kernel only
  double duration;
  const void *jobs, *rises, *wstab, *prm, *sc_in, *win_in;
  void *sc_out, *win_out;
  int* steps;      // run_kernel only
  cudaStream_t stream;
};

// RUN: the whole outer loop (run_kernel), else one outer step
// (chunk_kernel).
template <typename T, bool FB, bool COAL, bool RUN>
cudaError_t launch(const LaunchArgs& a) {
  const int threads = ((a.d.K + 31) / 32) * 32;
  const size_t smem = sizeof(Scratch<T>) + 6 * (size_t)a.d.K * sizeof(T)
                      + (COAL ? 3 * (size_t)a.d.batch * sizeof(T) : 0);
  const void* fn = RUN ? (const void*)run_kernel<T, FB, COAL>
                       : (const void*)chunk_kernel<T, FB, COAL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const T* jobs = static_cast<const T*>(a.jobs);
  const T* rises = static_cast<const T*>(a.rises);
  const T* wstab = static_cast<const T*>(a.wstab);
  const T* prm = static_cast<const T*>(a.prm);
  const T* sc_in = static_cast<const T*>(a.sc_in);
  const T* win_in = static_cast<const T*>(a.win_in);
  T* sc_out = static_cast<T*>(a.sc_out);
  T* win_out = static_cast<T*>(a.win_out);
  if constexpr (RUN)
    run_kernel<T, FB, COAL><<<a.n_lanes, threads, smem, a.stream>>>(
        a.d, a.outer_max, a.duration, jobs, rises, wstab, prm, sc_in,
        win_in, sc_out, win_out, a.steps);
  else
    chunk_kernel<T, FB, COAL><<<a.n_lanes, threads, smem, a.stream>>>(
        a.d, a.duration, jobs, rises, wstab, prm, sc_in, win_in, sc_out,
        win_out);
  return cudaGetLastError();
}

template <typename T, bool RUN>
cudaError_t dispatch(int policy, const LaunchArgs& a) {
  if (a.d.batch > 1)
    return policy == 0 ? launch<T, true, true, RUN>(a)
                       : launch<T, false, true, RUN>(a);
  return policy == 0 ? launch<T, true, false, RUN>(a)
                     : launch<T, false, false, RUN>(a);
}

cudaError_t check_args(int K, int Jp, int NR, int NT, int batch) {
  if (K < 1 || K > 1024 || Jp < K || NR < 1 || NT < 1 || batch < 1 ||
      batch > K)
    return cudaErrorInvalidValue;
  return cudaSuccess;
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

// policy: 0 = FB, 1 = FLB-NUB; batch: the coalescing batch in [1, K]
// (1 = off). One outer step of every lane. Returns the cudaError_t of the
// launch.
extern "C" int round_step_chunk(int policy, int is_f64, int n_lanes, int K,
                                int Jp, int NR, int NT, int rounds,
                                int ff_passes, int batch, double duration,
                                const void* jobs, const void* rises,
                                const void* wstab, const void* prm,
                                const void* sc_in, const void* win_in,
                                void* sc_out, void* win_out, void* stream) {
  if (n_lanes <= 0) return 0;
  const cudaError_t bad = check_args(K, Jp, NR, NT, batch);
  if (bad != cudaSuccess) return (int)bad;
  const LaunchArgs a{n_lanes, Dims{K, Jp, NR, NT, rounds, ff_passes, batch},
                     0, duration, jobs, rises, wstab, prm, sc_in, win_in,
                     sc_out, win_out, nullptr,
                     static_cast<cudaStream_t>(stream)};
  return (int)(is_f64 ? dispatch<double, false>(policy, a)
                      : dispatch<float, false>(policy, a));
}

// The same, but every lane runs outer steps until its predicate
// (steps < outer_max) & (t < duration) fails, all in one launch; steps
// (n_lanes int32) gets each lane's outer-step count.
extern "C" int round_step_run(int policy, int is_f64, int n_lanes, int K,
                              int Jp, int NR, int NT, int rounds,
                              int ff_passes, int batch, int outer_max,
                              double duration, const void* jobs,
                              const void* rises, const void* wstab,
                              const void* prm, const void* sc_in,
                              const void* win_in, void* sc_out,
                              void* win_out, void* steps, void* stream) {
  if (n_lanes <= 0) return 0;
  const cudaError_t bad = check_args(K, Jp, NR, NT, batch);
  if (bad != cudaSuccess) return (int)bad;
  const LaunchArgs a{n_lanes, Dims{K, Jp, NR, NT, rounds, ff_passes, batch},
                     outer_max, duration, jobs, rises, wstab, prm, sc_in,
                     win_in, sc_out, win_out, static_cast<int*>(steps),
                     static_cast<cudaStream_t>(stream)};
  return (int)(is_f64 ? dispatch<double, true>(policy, a)
                      : dispatch<float, true>(policy, a));
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
