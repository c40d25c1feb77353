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
// dot products, so the work is bound by memory bytes. The TPU kernel
// walks the cache in order on one core; on Hopper the rows of one
// (batch, kv head) pair must be spread over many SMs to reach the
// memory rate. So this is split-K ("flash decoding") in two launches:
//
//  1. decode_split: one 256-thread block per (chunk of CK = 256 keys,
//     row group). Blocks whose chunk holds no visible key return at
//     once. A block scores its keys against the G queries (lanes split
//     HD, 16-byte loads, neighbouring lanes on neighbouring addresses),
//     takes its chunk-local max and exp-sum per query and the
//     probability-weighted sum of its V rows, and writes (m, l, acc).
//  2. decode_combine: per row group, rescales the chunks' partials by
//     exp(m_c - max m) and divides, in float32, then casts to q's type.
//
// Both launches derive the visible chunk range from `pos` the same way,
// so the combine reads only chunks the split wrote.

#include "common.cuh"

namespace {

constexpr int CK = 256;   // keys per split block
constexpr int NT = 256;   // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXG = 8;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Visible keys [lo, hi) and the chunks that hold any of them.
struct Range {
  int lo, hi, c_lo, c_hi;
};

__device__ __forceinline__ Range visible(int pos, int s, int window) {
  Range r;
  r.hi = min(pos + 1, s);
  r.lo = window > 0 ? max(0, pos - window + 1) : 0;
  if (r.hi <= r.lo) {
    r.c_lo = 0;
    r.c_hi = 0;
  } else {
    r.c_lo = r.lo / CK;
    r.c_hi = (r.hi - 1) / CK + 1;
  }
  return r;
}

template <typename TKV, int HD>
constexpr size_t split_smem_bytes(int g) {
  // q (g, HD) + scores (g, CK) + per-key-group partial sums (g, NT * E)
  return sizeof(float) * (static_cast<size_t>(g) * HD + g * CK +
                          static_cast<size_t>(g) * NT * Vec<TKV>::N);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NT)
    decode_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const int* __restrict__ pos_p,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int s, int g, int window, float softcap, float scale) {
  constexpr int E = Vec<TKV>::N;              // elements per 16-byte load
  constexpr int LPK = (HD / E) < 32 ? (HD / E) : 32;  // lanes per key
  constexpr int NV = HD / (E * LPK);          // loads per lane per key
  constexpr int KPS = 32 / LPK;               // keys per warp step
  constexpr int CV = HD / E;                  // 16-byte columns of a row
  constexpr int KG = NT / CV;                 // key groups in the PV pass
  static_assert(CV <= NT, "row too wide");

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int nchunk = gridDim.x;
  const Range r = visible(*pos_p, s, window);
  const int c0 = chunk * CK;
  const int k_lo = max(r.lo, c0);
  const int k_hi = min(r.hi, c0 + CK);
  if (k_lo >= k_hi) return;       // nothing visible: the combine skips it

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // (g, HD), scaled
  float* ss = sq + g * HD;                      // (g, CK) scores → p
  float* sred = ss + g * CK;                    // (KG, g, HD) partials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TQ* qb = q + static_cast<size_t>(b) * g * HD;
  for (int i = tid; i < g * HD; i += NT) sq[i] = to_float(qb[i]) * scale;
  __syncthreads();

  // Scores: a group of LPK lanes per key, KPS keys per warp step; each
  // lane keeps the query elements it multiplies in registers.
  const TKV* kb = k + static_cast<size_t>(b) * s * HD;
  const int sub = lane / LPK;     // which key of the step
  const int sl = lane % LPK;      // lane within the key's group
  float qr[MAXG][NV][E];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[gi][n][e] = gi < g ? sq[gi * HD + (n * LPK + sl) * E + e] : 0.f;
  for (int jb = warp * KPS; jb < CK; jb += NWARP * KPS) {
    const int j = c0 + jb + sub;
    const bool live = j >= k_lo && j < k_hi;
    float kv[NV][E];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      if (live)
        load16(kb + static_cast<size_t>(j) * HD + (n * LPK + sl) * E, kv[n]);
      else
#pragma unroll
        for (int e = 0; e < E; ++e) kv[n][e] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      if (gi < g) {
        float dot = 0.f;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[gi][n][e], kv[n][e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (sl == 0) {
          float x = dot;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          ss[gi * CK + jb + sub] = live ? x : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // Chunk-local softmax statistics: warp gi handles query gi.
  float* ml = part_ml + (static_cast<size_t>(b) * nchunk + chunk) * g * 2;
  if (warp < g) {
    float* row = ss + warp * CK;
    float mx = NEG_INF;
    for (int j = lane; j < CK; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < CK; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[2 * warp] = mx;
      ml[2 * warp + 1] = sum;
    }
  }
  __syncthreads();

  // p · V over the visible keys: thread = (16-byte column, key group).
  const TKV* vb = v + static_cast<size_t>(b) * s * HD;
  const int cv = tid % CV;
  const int kg = tid / CV;
  float acc[MAXG][E];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  if (kg < KG) {
    for (int j = k_lo + kg; j < k_hi; j += KG) {
      float vv[E];
      load16(vb + static_cast<size_t>(j) * HD + cv * E, vv);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi < g) {
          const float p = ss[gi * CK + (j - c0)];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(p, vv[e], acc[gi][e]);
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
      if (gi < g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          sred[(static_cast<size_t>(kg) * g + gi) * HD + cv * E + e] =
              acc[gi][e];
  }
  __syncthreads();
  float* out = part_acc + (static_cast<size_t>(b) * nchunk + chunk) * g * HD;
  for (int i = tid; i < g * HD; i += NT) {
    float sum = 0.f;
    for (int kk = 0; kk < KG; ++kk) sum += sred[static_cast<size_t>(kk) * g * HD + i];
    out[i] = sum;
  }
}

template <typename TQ, int HD>
__global__ void __launch_bounds__(NT)
    decode_combine(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ pos_p, TQ* __restrict__ o, int s,
                   int g, int window, int nchunk) {
  const int b = blockIdx.x;
  const Range r = visible(*pos_p, s, window);
  for (int i = threadIdx.x; i < g * HD; i += NT) {
    const int gi = i / HD;
    float mx = NEG_INF;
    for (int c = r.c_lo; c < r.c_hi; ++c)
      mx = fmaxf(mx, part_ml[((static_cast<size_t>(b) * nchunk + c) * g + gi) * 2]);
    float l = 0.f, acc = 0.f;
    for (int c = r.c_lo; c < r.c_hi; ++c) {
      const size_t base = static_cast<size_t>(b) * nchunk + c;
      const float w = expf(part_ml[(base * g + gi) * 2] - mx);
      l = fmaf(w, part_ml[(base * g + gi) * 2 + 1], l);
      acc = fmaf(w, part_acc[base * g * HD + i], acc);
    }
    store_out(o + static_cast<size_t>(b) * g * HD + i,
              acc / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(int bkv, int g, int s, int window, float softcap,
                   float scale, const void* q, const void* k, const void* v,
                   const void* pos, void* part_acc, void* part_ml, void* o,
                   cudaStream_t stream) {
  const int nchunk = (s + CK - 1) / CK;
  const size_t smem = split_smem_bytes<TKV, HD>(g);
  auto split = decode_split<TQ, TKV, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split<<<dim3(nchunk, bkv), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), s, g,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<TQ, HD><<<bkv, NT, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(pos), static_cast<TQ*>(o), s, g, window,
      nchunk);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(int hd, int bkv, int g, int s, int window,
                     float softcap, float scale, const void* q,
                     const void* k, const void* v, const void* pos,
                     void* pa, void* pm, void* o, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16>(bkv, g, s, window, softcap, scale, q, k, v, pos, pa, pm, o, st);
    case 32: return launch<TQ, TKV, 32>(bkv, g, s, window, softcap, scale, q, k, v, pos, pa, pm, o, st);
    case 64: return launch<TQ, TKV, 64>(bkv, g, s, window, softcap, scale, q, k, v, pos, pa, pm, o, st);
    case 128: return launch<TQ, TKV, 128>(bkv, g, s, window, softcap, scale, q, k, v, pos, pa, pm, o, st);
    case 256: return launch<TQ, TKV, 256>(bkv, g, s, window, softcap, scale, q, k, v, pos, pa, pm, o, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Keys per split block: the wrapper sizes the partial buffers
// part_acc (BKV, ceil(S / CK), G, HD) and part_ml (BKV, ceil(S / CK), G, 2),
// both float32.
int flash_decode_chunk_keys() { return CK; }

// q_dtype / kv_dtype: 0 float32, 1 bfloat16 (q bfloat16 with a float32
// cache is refused). pos: a device int32. window <= 0: none; softcap
// <= 0: none. Returns a cudaError_t (0 on success); both launches are
// asynchronous on `stream`.
int flash_decode_fwd(int q_dtype, int kv_dtype, int bkv, int g, int s,
                     int hd, int window, float softcap, float scale,
                     const void* q, const void* k, const void* v,
                     const void* pos, void* part_acc, void* part_ml, void* o,
                     void* stream) {
  if (bkv <= 0 || bkv > 65535 || g <= 0 || g > MAXG || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = dispatch<float, float>(hd, bkv, g, s, window, softcap, scale, q, k,
                                 v, pos, part_acc, part_ml, o, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(
        hd, bkv, g, s, window, softcap, scale, q, k, v, pos, part_acc,
        part_ml, o, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = dispatch<float, __nv_bfloat16>(hd, bkv, g, s, window, softcap,
                                         scale, q, k, v, pos, part_acc,
                                         part_ml, o, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
