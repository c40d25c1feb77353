// Flash decode for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py::flash_decode_bkv (body
// _decode_kernel): one query token per (batch, kv head) row group
// attends to a KV cache with an online softmax. The write position
// `pos` is read from device memory, so a decode step neither recompiles
// nor synchronises. Key k is visible iff k <= pos, k < S and, with a
// window, k > pos - window; the logit softcap comes before the mask, a
// masked score is -2e38, accumulation is in float32 and l is clamped at
// 1e-30.
//
// Layout: q (BKV, G, HD), k / v (BKV, S, HD), o (BKV, G, HD), all
// contiguous; q and o share a type, k and v share a type; float32 or
// bfloat16 (q float32 with a bfloat16 cache is allowed). HD is one of
// 16, 32, 64, 128, 256 and G is at most 8.
//
// What bounds it: every visible K and V row is read once and used for G
// dot products (G <= 8 rows per key, far below the tensor cores' line),
// so the work is bound by memory bytes and stays float32 on the CUDA
// cores. The TPU kernel walks the cache in order on one core; on Hopper
// the rows of one row group are spread over many SMs ("flash decoding",
// split-K), and each SM's share of the memory rate must stay busy:
//
//  - decode_split: grid (BKV, NB), NB = the number of SMs / BKV (the
//    wrapper's choice: one wave of one 256-thread block per SM). Block
//    (b, y) takes the y-th of NB contiguous runs of the visible CK-key
//    chunks of row group b (CK: 16 KB of K rows, 32 keys at HD 256 in
//    bfloat16, 16 in float32; at most 256) and streams them through a
//    ring of 4 stages of (K, V) in shared memory (128 KB), loaded by
//    cp.async, 16 bytes a thread, K and V of a chunk in one group: three
//    chunks (96 KB) are in flight while one is used, behind one block
//    barrier per chunk.
//  - Each warp works alone on its share of a chunk's keys (a whole warp
//    per key row at HD 256; narrower rows put several keys side by side)
//    with its own online softmax: running max, exp-sum and float32 PV
//    sums in registers, exponentials and the softcap's tanh on the
//    special-function unit (ex2). The work per key, not the copies, set
//    the pace of the first versions (with the arithmetic removed the
//    same ring streamed the cache at about the copy rate, with it far
//    slower): so the loops over the G queries run to MG, a bound known
//    to the compiler (2 or 8; q rows g .. MG - 1 are zero and never
//    stored), and rows past a chunk's end are zeroed by selects, so the
//    unrolled loops hold no branch. At the end the warps merge through
//    shared memory and the block writes its (m, l, acc) partial.
//  - The combine, folded into the same launch: the last block of a row
//    group to finish (an atomic counter per row group, reset by that
//    block) rescales the runs' partials by exp(m_y - max m), sums them,
//    divides and casts to q's type, so a step is one launch. It was 2-3
//    us faster than a second launch of one block per row group, the
//    first design (PERF.md). With no visible key (pos < 0, or every key
//    left of the window) no block has a run, and block 0 writes zeros.

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;   // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXG = 8;
constexpr int STAGES = 4;
constexpr int K_BYTES = 16384;   // K rows per chunk (and as many V bytes)
constexpr int MAX_CK = 256;

template <typename T>
__host__ __device__ constexpr int chunk_keys(int hd) {
  return K_BYTES / (hd * static_cast<int>(sizeof(T))) < MAX_CK
             ? K_BYTES / (hd * static_cast<int>(sizeof(T)))
             : MAX_CK;
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Visible keys [lo, hi), the chunks [c_lo, c_hi) that hold any of them,
// and the run length per block: block y takes chunks c_lo + y per ..
// c_lo + (y + 1) per - 1 that lie below c_hi (none for some y when there
// are few).
struct Range {
  int lo, hi, c_lo, c_hi, per;
  __device__ __forceinline__ int runs() const {
    return per > 0 ? (c_hi - c_lo + per - 1) / per : 0;
  }
};

__device__ __forceinline__ Range visible(int pos, int s, int window, int ck,
                                         int nb) {
  Range r;
  r.hi = min(pos + 1, s);
  r.lo = window > 0 ? max(0, pos - window + 1) : 0;
  if (r.hi <= r.lo) {
    r.c_lo = r.c_hi = r.per = 0;
  } else {
    r.c_lo = r.lo / ck;
    r.c_hi = (r.hi - 1) / ck + 1;
    r.per = (r.c_hi - r.c_lo + nb - 1) / nb;
  }
  return r;
}

// The ring of (K, V) stages, then q (MG, HD), the combine's scratch
// (2 MAXG floats) and a flag; after the last chunk the ring holds the
// warps' partials (NWARP g (HD + 2) floats).
template <typename TKV, int HD>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * static_cast<size_t>(chunk_keys<TKV>(HD)) * HD * sizeof(TKV);
}

template <typename TKV, int HD>
__host__ __device__ constexpr size_t split_smem_bytes(int mg) {
  return STAGES * stage_bytes<TKV, HD>() +
         sizeof(float) * (static_cast<size_t>(mg) * HD + 2 * MAXG) + 16;
}

// Row group b's output from its runs' partials (all NT threads of the
// block; sm: 2 MAXG floats of shared memory). Partials are read through
// L2 (ld.global.cg): other blocks wrote them.
template <typename TQ, int HD>
__device__ __forceinline__ void combine_group(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    TQ* __restrict__ o, int b, int g, int nb, int runs, float* sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ml = part_ml + static_cast<size_t>(b) * nb * g * 2;
  // Warp gi: the row's max over the runs, then l.
  if (warp < g) {
    float mx = NEG_INF;
    for (int y = lane; y < runs; y += 32)
      mx = fmaxf(mx, __ldcg(ml + (static_cast<size_t>(y) * g + warp) * 2));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int y = lane; y < runs; y += 32) {
      const float* p = ml + (static_cast<size_t>(y) * g + warp) * 2;
      l = fmaf(expf(__ldcg(p) - mx), __ldcg(p + 1), l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sm[2 * warp] = mx;
      sm[2 * warp + 1] = l;
    }
  }
  __syncthreads();
  const float* pa = part_acc + static_cast<size_t>(b) * nb * g * HD;
  for (int i = tid; i < g * HD; i += NT) {
    const int gi = i / HD;
    const float mx = sm[2 * gi];
    float acc = 0.f;
    for (int y = 0; y < runs; ++y) {
      const float w =
          expf(__ldcg(ml + (static_cast<size_t>(y) * g + gi) * 2) - mx);
      acc = fmaf(w, __ldcg(pa + static_cast<size_t>(y) * g * HD + i), acc);
    }
    store_out(o + static_cast<size_t>(b) * g * HD + i,
              acc / fmaxf(sm[2 * gi + 1], 1e-30f));
  }
}

// MG: a bound on G known to the compiler (2 or 8), so the per-key loops
// over the queries unroll without branches; rows g .. MG - 1 of q are
// zero and nothing of them is stored.
template <typename TQ, typename TKV, int HD, int MG>
__global__ void __launch_bounds__(NT, 1)
    decode_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const int* __restrict__ pos_p,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 TQ* __restrict__ o, int* __restrict__ counters, int s,
                 int g, int window, float softcap, float scale) {
  constexpr int CK = chunk_keys<TKV>(HD);
  constexpr int E = Vec<TKV>::N;              // elements per 16-byte load
  constexpr int LPK = (HD / E) < 32 ? (HD / E) : 32;  // lanes per key
  constexpr int NV = HD / (E * LPK);          // loads per lane per row
  constexpr int KPS = 32 / LPK;               // keys side by side in a warp
  constexpr int KU0 = CK / (NWARP * KPS);
  constexpr int KU = KU0 < 1 ? 1 : (KU0 > 4 ? 4 : KU0);  // keys per lane group
  constexpr int UNIT = NWARP * KPS * KU;      // keys per pass of the block
  constexpr int PPR = HD / E;                 // 16-byte pieces per row

  const int b = blockIdx.x;
  const int y = blockIdx.y;
  const int nb = gridDim.y;
  const Range r = visible(*pos_p, s, window, CK, nb);
  const int c_first = r.c_lo + y * r.per;
  const int c_last = min(r.c_hi, c_first + r.per);   // exclusive
  if (c_first >= c_last) {   // no run: the combine skips this block
    if (r.runs() == 0 && y == 0)
      for (int i = threadIdx.x; i < g * HD; i += NT)
        store_out(o + static_cast<size_t>(b) * g * HD + i, 0.f);
    return;
  }
  const int mine = c_last - c_first;

  extern __shared__ __align__(128) uint8_t smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* sq = reinterpret_cast<float*>(smem + STAGES * stage_bytes<TKV, HD>());
  float* scratch = sq + MG * HD;              // 2 MAXG floats
  int* last = reinterpret_cast<int*>(scratch + 2 * MAXG);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TKV* kb = k + static_cast<size_t>(b) * s * HD;
  const TKV* vb = v + static_cast<size_t>(b) * s * HD;

  // Chunk c_first + t's visible K and V rows into stage t % STAGES, one
  // cp.async group per thread (an empty group past the run keeps the
  // group count aligned).
  auto load_chunk = [&](int t) {
    if (t < mine) {
      const int c = c_first + t;
      const int k0 = max(r.lo, c * CK);
      const int n = min(r.hi, c * CK + CK) - k0;
      TKV* stage = ring + static_cast<size_t>(t % STAGES) * 2 * CK * HD;
      for (int i = tid; i < 2 * n * PPR; i += NT) {
        const int half = i >= n * PPR;          // 0: K, 1: V
        const int j = i - half * n * PPR;
        const size_t off = static_cast<size_t>(j / PPR) * HD + (j % PPR) * E;
        cp_async16(smem_u32(stage + half * CK * HD + off),
                   (half ? vb : kb) + static_cast<size_t>(k0) * HD + off, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_chunk(t);

  const TQ* qb = q + static_cast<size_t>(b) * g * HD;
  for (int i = tid; i < MG * HD; i += NT)
    sq[i] = i < g * HD ? to_float(qb[i]) * scale : 0.f;
  __syncthreads();

  // A warp works alone on its keys: KPS groups of LPK lanes side by side,
  // each lane holding NV x E elements of a row (and of q, in registers),
  // KU keys per group and pass, with its own running max m, exp-sum l
  // and PV sums (l and acc per lane group; m shared by the warp).
  const int sub = lane / LPK;     // which lane group
  const int sl = lane % LPK;      // lane within the group
  float qr[MG][NV][E];
#pragma unroll
  for (int gi = 0; gi < MG; ++gi)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[gi][nv][e] = sq[gi * HD + (nv * LPK + sl) * E + e];
  float m[MG], l[MG], acc[MG][NV][E];
#pragma unroll
  for (int gi = 0; gi < MG; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][nv][e] = 0.f;
  }
  const bool capped = softcap > 0.f;
  const float inv_cap = capped ? 1.f / softcap : 0.f;

  for (int t = 0; t < mine; ++t) {
    cp_async_wait<STAGES - 2>();   // chunk t has landed (this thread's part)
    __syncthreads();               // ... every thread's; chunk t - 1 is done
    load_chunk(t + STAGES - 1);    // into chunk t - 1's stage
    const int c = c_first + t;
    const int n = min(r.hi, c * CK + CK) - max(r.lo, c * CK);
    const TKV* sk = ring + static_cast<size_t>(t % STAGES) * 2 * CK * HD;
    const TKV* sv = sk + CK * HD;

    for (int base = 0; base < n; base += UNIT) {
      // Rows past n hold stale data: loaded all the same (they lie inside
      // the stage), then replaced by zeros, so no branch splits the
      // unrolled loops.
      float kv[KU][NV][E];
      bool live[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int j = base + (u * NWARP + warp) * KPS + sub;
        live[u] = j < n;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          load16(sk + static_cast<size_t>(j) * HD + (nv * LPK + sl) * E,
                 kv[u][nv]);
#pragma unroll
          for (int e = 0; e < E; ++e) kv[u][nv][e] = live[u] ? kv[u][nv][e] : 0.f;
        }
      }
      // Scores (q carries the scale), summed over the lane group.
      float x[KU][MG];
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int gi = 0; gi < MG; ++gi) {
          float dot = 0.f;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv)
#pragma unroll
            for (int e = 0; e < E; ++e)
              dot = fmaf(qr[gi][nv][e], kv[u][nv][e], dot);
          x[u][gi] = dot;
        }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < KU; ++u)
#pragma unroll
          for (int gi = 0; gi < MG; ++gi)
            x[u][gi] += __shfl_xor_sync(0xffffffffu, x[u][gi], off);
      // The online softmax, per query.
#pragma unroll
      for (int gi = 0; gi < MG; ++gi) {
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const float xc = cap_tanh(x[u][gi] * inv_cap, softcap);
          x[u][gi] = live[u] ? (capped ? xc : x[u][gi]) : NEG_INF;
          mx = fmaxf(mx, x[u][gi]);
        }
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[gi], mx);
        const float alpha = ex2((m[gi] - m_new) * LOG2E);
        m[gi] = m_new;
        l[gi] *= alpha;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[gi][nv][e] *= alpha;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const float p = live[u] ? ex2((x[u][gi] - m_new) * LOG2E) : 0.f;
          x[u][gi] = p;
          l[gi] += p;
        }
      }
      // p · V, the same rows of V.
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int j = base + (u * NWARP + warp) * KPS + sub;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          load16(sv + static_cast<size_t>(j) * HD + (nv * LPK + sl) * E,
                 kv[u][nv]);
#pragma unroll
          for (int e = 0; e < E; ++e) kv[u][nv][e] = live[u] ? kv[u][nv][e] : 0.f;
        }
#pragma unroll
        for (int gi = 0; gi < MG; ++gi)
#pragma unroll
          for (int nv = 0; nv < NV; ++nv)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[gi][nv][e] = fmaf(x[u][gi], kv[u][nv][e], acc[gi][nv][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // Each warp's (m, l, acc): the lane groups' sums, then in the ring.
  float* wacc = reinterpret_cast<float*>(smem);      // (NWARP, g, HD)
  float* wml = wacc + NWARP * g * HD;                // (NWARP, g, 2)
#pragma unroll
  for (int gi = 0; gi < MG; ++gi) {
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[gi][nv][e] += __shfl_xor_sync(0xffffffffu, acc[gi][nv][e], off);
    }
    if (gi < g && sub == 0) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < E; ++e)
          wacc[(warp * g + gi) * HD + (nv * LPK + sl) * E + e] = acc[gi][nv][e];
      if (sl == 0) {
        wml[(warp * g + gi) * 2] = m[gi];
        wml[(warp * g + gi) * 2 + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  // The block's partial: the warps merged per query.
  float* out = part_acc + (static_cast<size_t>(b) * nb + y) * g * HD;
  for (int i = tid; i < g * HD; i += NT) {
    const int gi = i / HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, wml[(w * g + gi) * 2]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      sum = fmaf(ex2((wml[(w * g + gi) * 2] - mx) * LOG2E),
                 wacc[(w * g + gi) * HD + i % HD], sum);
    out[i] = sum;
  }
  if (tid < g) {
    float mx = NEG_INF, sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, wml[(w * g + tid) * 2]);
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      sum = fmaf(ex2((wml[(w * g + tid) * 2] - mx) * LOG2E),
                 wml[(w * g + tid) * 2 + 1], sum);
    float* ml = part_ml + ((static_cast<size_t>(b) * nb + y) * g + tid) * 2;
    ml[0] = mx;
    ml[1] = sum;
  }

  // The last block of the row group to get here combines.
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + b, 1) == r.runs() - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  combine_group<TQ, HD>(part_acc, part_ml, o, b, g, nb, r.runs(), scratch);
  if (tid == 0) counters[b] = 0;   // ready for the next launch
}

template <typename TQ, typename TKV, int HD, int MG>
cudaError_t launch_mg(int bkv, int g, int s, int window, int nb,
                      float softcap, float scale, const void* q,
                      const void* k, const void* v, const void* pos,
                      void* part_acc, void* part_ml, void* o, void* counters,
                      cudaStream_t stream) {
  const size_t smem = split_smem_bytes<TKV, HD>(MG);
  auto split = decode_split<TQ, TKV, HD, MG>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split<<<dim3(bkv, nb), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<TQ*>(o), static_cast<int*>(counters), s, g, window,
      softcap, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(int bkv, int g, int s, int window, int nb, float softcap,
                   float scale, const void* q, const void* k, const void* v,
                   const void* pos, void* part_acc, void* part_ml, void* o,
                   void* counters, cudaStream_t stream) {
  return g <= 2 ? launch_mg<TQ, TKV, HD, 2>(bkv, g, s, window, nb, softcap,
                                            scale, q, k, v, pos, part_acc,
                                            part_ml, o, counters, stream)
                : launch_mg<TQ, TKV, HD, MAXG>(bkv, g, s, window, nb,
                                               softcap, scale, q, k, v, pos,
                                               part_acc, part_ml, o,
                                               counters, stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch(int hd, int bkv, int g, int s, int window, int nb,
                     float softcap, float scale, const void* q,
                     const void* k, const void* v, const void* pos,
                     void* pa, void* pm, void* o, void* cnt,
                     cudaStream_t st) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16>(bkv, g, s, window, nb, softcap, scale, q, k, v, pos, pa, pm, o, cnt, st);
    case 32: return launch<TQ, TKV, 32>(bkv, g, s, window, nb, softcap, scale, q, k, v, pos, pa, pm, o, cnt, st);
    case 64: return launch<TQ, TKV, 64>(bkv, g, s, window, nb, softcap, scale, q, k, v, pos, pa, pm, o, cnt, st);
    case 128: return launch<TQ, TKV, 128>(bkv, g, s, window, nb, softcap, scale, q, k, v, pos, pa, pm, o, cnt, st);
    case 256: return launch<TQ, TKV, 256>(bkv, g, s, window, nb, softcap, scale, q, k, v, pos, pa, pm, o, cnt, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Keys per chunk for a cache of kv_dtype (0 float32, 1 bfloat16) and
// head dim hd (0 for an unknown dtype): the wrapper caps the number of
// runs NB at ceil(S / CK).
int flash_decode_chunk_keys(int kv_dtype, int hd) {
  if (hd <= 0) return 0;
  return kv_dtype == 0 ? chunk_keys<float>(hd)
                       : kv_dtype == 1 ? chunk_keys<__nv_bfloat16>(hd) : 0;
}

// q_dtype / kv_dtype: 0 float32, 1 bfloat16 (q bfloat16 with a float32
// cache is refused). pos: a device int32. window <= 0: none; softcap
// <= 0: none. nb: runs (blocks) per row group; part_acc (BKV, nb, G, HD)
// and part_ml (BKV, nb, G, 2), float32. counters: BKV int32, zero before
// the launch and zero again after it (the last block of each row group
// counts on it and combines); launches that may overlap need their own.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
int flash_decode_fwd(int q_dtype, int kv_dtype, int bkv, int g, int s,
                     int hd, int window, int nb, float softcap, float scale,
                     const void* q, const void* k, const void* v,
                     const void* pos, void* part_acc, void* part_ml, void* o,
                     void* counters, void* stream) {
  if (bkv <= 0 || bkv > 65535 || g <= 0 || g > MAXG || s <= 0 || nb <= 0 ||
      nb > 65535 || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = dispatch<float, float>(hd, bkv, g, s, window, nb, softcap, scale, q,
                                 k, v, pos, part_acc, part_ml, o, counters,
                                 st);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(
        hd, bkv, g, s, window, nb, softcap, scale, q, k, v, pos, part_acc,
        part_ml, o, counters, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = dispatch<float, __nv_bfloat16>(hd, bkv, g, s, window, nb, softcap,
                                         scale, q, k, v, pos, part_acc,
                                         part_ml, o, counters, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
