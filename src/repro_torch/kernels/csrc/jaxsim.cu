// The section 6.6.4 FLB-NUB tick simulator (repro_torch.core.jaxsim).
//
// The counterpart of the jitted lax.scan of the JAX package's
// repro.core.jaxsim.simulate (src/repro/core/jaxsim.py:152), vmapped there
// over parameter lanes; that module has no Pallas kernel. ONE launch runs
// a whole study: one block per parameter lane, each block stepping its
// lane through all n_steps substeps of dt = lease / substeps. A substep:
//   1. every thread advances its jobs (remaining -= dt, completion at
//      remaining <= 0 with finish = t) and sums its queued sizes (demand),
//      running sizes (used), the largest queued size and the first and
//      last queued index; a block reduction (barrier 1) hands the totals
//      to warp 0;
//   2. warp 0 runs the policy step in all 32 lanes at once (the same
//      values in the same order, so no broadcast): at a tick the pool's
//      grant and the section 5.2 U / V / G adjust, then the first-fit in
//      arrival order as jumps: the sequential scan starts job i iff it is
//      queued and size[i] <= fr, and fr changes only at a start, so the
//      next start is the first queued job after the last one with
//      size <= fr; the warp finds it 32 jobs a ballot, between the first
//      and last queued index, starts it and subtracts its size, until none
//      fits; then the allocation of the substep is accumulated;
//   3. barrier 2, so the next substep's pass sees the starts.
// A lane's job state (remaining, finish, running / done flags) and its
// submit and size columns live in dynamic shared memory when the table
// fits (in_smem), else the state lives in the caller's global scratch
// (remaining and finish (L, 2, J), flags (L, J)) and submit / size are
// read from the inputs.
//
// Arithmetic is the reference's in the inputs' dtype: t = (s + 1) * dt,
// the ratio an IEEE division (no fast math; -fmad=false keeps every
// product and sum rounded on its own), node-hours = sum(alloc) * (dt *
// (1/3600)) as XLA folds the reference's division. Sizes and WS demands
// are integer-valued, so demand / used / alloc sums are exact in any
// order; the turnaround sum is taken in double and rounded once.
//
// What bounds it: neither bytes nor operations (a lane reads its table
// once and does a few operations per live job and substep). The time is
// the serial chain: per substep a pass over the table, two block
// barriers and warp 0's reduction, policy step and first-fit jumps, each
// waiting on the one before, times the 4032 substeps of a two-week
// trace; lanes run side by side on the SMs, so a study of up to a few
// hundred lanes costs about one lane's chain.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint8_t RUN = 1;
constexpr uint8_t DONE = 2;
constexpr int OUT = 5;   // completed, avg_turnaround, node_hours, peak, events

template <typename T>
struct Partial {
  T demand, used, biggest;
  int lo, hi;   // first and last queued index (lo = J, hi = -1 if none)
};

template <typename T>
__device__ __forceinline__ Partial<T> warp_reduce(Partial<T> p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.demand += __shfl_xor_sync(FULL, p.demand, o);
    p.used += __shfl_xor_sync(FULL, p.used, o);
    p.biggest = max(p.biggest, __shfl_xor_sync(FULL, p.biggest, o));
    p.lo = min(p.lo, __shfl_xor_sync(FULL, p.lo, o));
    p.hi = max(p.hi, __shfl_xor_sync(FULL, p.hi, o));
  }
  return p;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
jaxsim_kernel(int n_jobs, int n_steps, int substeps, T dt, T lb_ws,
              int in_smem, const T* __restrict__ submit,
              const T* __restrict__ size, const T* __restrict__ runtime,
              const T* __restrict__ ws, const T* __restrict__ prm,
              T* scratch, uint8_t* flag_scratch, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Partial<T> parts[WARPS];
  __shared__ double turn_parts[WARPS];
  __shared__ int done_parts[WARPS];

  const int J = n_jobs;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;

  const T* sub;
  const T* sz;
  T* rem;
  T* fin;
  uint8_t* flg;
  if (in_smem) {
    T* base = reinterpret_cast<T*>(smem);
    T* s_sub = base;
    T* s_sz = base + J;
    rem = base + 2 * J;
    fin = base + 3 * J;
    flg = reinterpret_cast<uint8_t*>(base + 4 * J);
    for (int j = tid; j < J; j += THREADS) {
      s_sub[j] = submit[j];
      s_sz[j] = size[j];
    }
    sub = s_sub;
    sz = s_sz;
  } else {
    sub = submit;
    sz = size;
    rem = scratch + static_cast<size_t>(lane) * 2 * J;
    fin = rem + J;
    flg = flag_scratch + static_cast<size_t>(lane) * J;
  }
  for (int j = tid; j < J; j += THREADS) {
    rem[j] = runtime[j];
    fin[j] = T(0);
    flg[j] = 0;
  }

  const T B = prm[lane * 4 + 0];
  const T U = prm[lane * 4 + 1];
  const T V = prm[lane * 4 + 2];
  const T G = prm[lane * 4 + 3];
  const T zero = T(0);
  const T inf = T(INFINITY);
  // warp 0's lane state (identical in its 32 lanes)
  T owned = max(B - lb_ws, T(1));
  T pool = owned;
  double alloc_sum = 0.0;
  T alloc_max = -inf;
  float events = 0.0f;
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const T t = (T(s) + T(1)) * dt;
    const bool tick = (s % substeps) == substeps - 1;
    T w = zero;
    if (warp == 0) w = ws[s];   // in flight during the pass

    // 1. advance the running jobs; read the queue
    Partial<T> p{zero, zero, zero, J, -1};
    for (int j = tid; j < J; j += THREADS) {
      uint8_t f = flg[j];
      const T z = sz[j];
      if (f & RUN) {
        const T r = rem[j] - dt;
        rem[j] = r;
        if (r <= zero) {
          fin[j] = t;
          f = DONE;
          flg[j] = f;
        }
      }
      if (f & RUN) {
        p.used += z;
      } else if (!(f & DONE) && sub[j] <= t) {
        p.demand += z;
        p.biggest = max(p.biggest, z);
        p.lo = min(p.lo, j);
        p.hi = j;
      }
    }
    p = warp_reduce(p);
    if (wl == 0) parts[warp] = p;
    __syncthreads();

    if (warp == 0) {
      Partial<T> q = wl < WARPS ? parts[wl] : Partial<T>{zero, zero, zero,
                                                         J, -1};
      q = warp_reduce(q);
      const T demand = q.demand, used = q.used, biggest = q.biggest;

      // 2+3. at a tick: the pool's grant and the U/V/G adjust
      const T pool_ws = min(w, lb_ws);
      T req = zero, rss = zero;
      if (tick) {
        const T grant = max(B - pool_ws - pool, zero);
        owned = owned + grant;
        pool = pool + grant;
        const T ratio = owned > zero ? demand / max(owned, T(1))
                                     : (demand > zero ? inf : zero);
        const T free = owned - used;
        if (ratio > U)
          req = max(demand - owned, zero);
        else if (biggest > owned)
          req = max(biggest - free, zero);
        if (ratio < V && req == zero) rss = floor(G * max(free, zero));
        owned = owned + req - rss;
        pool = min(pool, owned);
      }

      // 4. first-fit in arrival order, by jumps
      T fr = owned - used;
      const int end = q.hi + 1;
      int from = q.lo;
      while (from < end) {
        int found = -1;
        for (int base = from; base < end; base += 32) {
          const int j = base + wl;
          const bool fits = j < end && flg[j] == 0 && sub[j] <= t &&
                            sz[j] <= fr;
          const unsigned m = __ballot_sync(FULL, fits);
          if (m) {
            found = base + __ffs(m) - 1;
            break;
          }
        }
        if (found < 0) break;
        if (wl == 0) flg[found] = RUN;
        fr = fr - sz[found];
        from = found + 1;
      }

      // 5. accounting: B pool + leased + WS beyond its lower bound
      const T alloc = B + max(owned - pool, zero) + max(w - pool_ws, zero);
      alloc_sum += static_cast<double>(alloc);
      alloc_max = max(alloc_max, alloc);
      events += (req > zero ? 1.0f : 0.0f) + (rss > zero ? 1.0f : 0.0f);
    }
    __syncthreads();
  }

  // outputs: completed jobs and the turnaround sum
  double turn = 0.0;
  int n_done = 0;
  for (int j = tid; j < J; j += THREADS) {
    if (flg[j] & DONE) {
      turn += static_cast<double>(fin[j] - sub[j]);
      ++n_done;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    turn += __shfl_xor_sync(FULL, turn, o);
    n_done += __shfl_xor_sync(FULL, n_done, o);
  }
  if (wl == 0) {
    turn_parts[warp] = turn;
    done_parts[warp] = n_done;
  }
  __syncthreads();
  if (tid == 0) {
    double turn_all = 0.0;
    int done_all = 0;
    for (int k = 0; k < WARPS; ++k) {
      turn_all += turn_parts[k];
      done_all += done_parts[k];
    }
    T* o = out + static_cast<size_t>(lane) * OUT;
    o[0] = T(done_all);
    o[1] = T(turn_all) / T(done_all > 1 ? done_all : 1);
    o[2] = T(alloc_sum) * (dt * T(1.0 / 3600.0));
    o[3] = alloc_max;
    o[4] = T(events);
  }
}

template <typename T>
cudaError_t launch(int n_lanes, int n_jobs, int n_steps, int substeps,
                   double dt, double lb_ws, int in_smem, const void* submit,
                   const void* size, const void* runtime, const void* ws,
                   const void* prm, void* scratch, void* flags, void* out,
                   cudaStream_t stream) {
  const size_t smem =
      in_smem ? static_cast<size_t>(n_jobs) * (4 * sizeof(T) + 1) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      jaxsim_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  jaxsim_kernel<T><<<n_lanes, THREADS, smem, stream>>>(
      n_jobs, n_steps, substeps, static_cast<T>(dt), static_cast<T>(lb_ws),
      in_smem, static_cast<const T*>(submit), static_cast<const T*>(size),
      static_cast<const T*>(runtime), static_cast<const T*>(ws),
      static_cast<const T*>(prm), static_cast<T*>(scratch),
      static_cast<uint8_t*>(flags), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// One study: n_lanes blocks over one job table of n_jobs rows and n_steps
// substeps. prm (n_lanes, 4) = B, U, V, G; out (n_lanes, 5). With in_smem
// the dynamic shared memory holds n_jobs * (4 * sizeof(T) + 1) bytes
// (jaxsim_smem_limit bounds it); else scratch holds n_lanes * 2 * n_jobs
// values and flags n_lanes * n_jobs bytes.
extern "C" int jaxsim_run(int is_f64, int n_lanes, int n_jobs, int n_steps,
                          int substeps, int in_smem, double dt, double lb_ws,
                          const void* submit, const void* size,
                          const void* runtime, const void* ws,
                          const void* prm, void* scratch, void* flags,
                          void* out, void* stream) {
  if (n_lanes <= 0 || n_jobs <= 0 || n_steps <= 0 || substeps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch<double>(n_lanes, n_jobs, n_steps, substeps,
                                       dt, lb_ws, in_smem, submit, size,
                                       runtime, ws, prm, scratch, flags,
                                       out, st)
                      : launch<float>(n_lanes, n_jobs, n_steps, substeps,
                                      dt, lb_ws, in_smem, submit, size,
                                      runtime, ws, prm, scratch, flags, out,
                                      st));
}

// The dynamic shared memory a block may opt in to on `device`, less the
// kernel's static shared memory; a negative cudaError_t on failure.
extern "C" int jaxsim_smem_limit(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, jaxsim_kernel<double>);
  if (err != cudaSuccess) return -(int)err;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

extern "C" const char* jaxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
