// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bkv (body
// _flash_kernel): blocked online-softmax attention, GQA by row grouping
// (q row b reads kv row b / G), causal mask, sliding window (a key k is
// visible from query position p iff k > p - window), logit softcap
// applied to (q*scale).k before the mask, a query offset for rectangular
// q / kv, masked scores at -2e38 (not -inf), f32 accumulators and
// l clamped at 1e-30 before the division.
//
// Layout: q (BH, Sq, HD), k / v (BKV, Skv, HD), o (BH, Sq, HD), all
// contiguous, BH = BKV * G; float32 or bfloat16 (q, k, v and o share
// the type). HD is one of 16, 32, 64, 128, 256.
//
// What bounds it: at the prefill shapes of gemma2-2b (HD 256, S in the
// thousands) the work is 4*HD flops per visible (q, k) pair against
// 4*S*HD bytes per head, so it is bound by arithmetic. This first
// version keeps every product in float32 on the CUDA cores (no tensor
// cores, no TMA): the float32 path must agree with the plain version to
// ~1e-5, which TF32 tensor cores would not, and bfloat16 inputs are
// widened to float32 in shared memory and run the same code.
//
// Design. One thread block of 256 threads computes a BQ = 64 row tile of
// one q row and walks the BK = 64 key tiles it can see: key tiles
// entirely above the causal diagonal or entirely left of the window are
// never loaded (the Pallas kernel skips them too). Tiles: the TPU's
// 128 x 128 blocks at HD 256 need q + k + v = 384 KB in float32, far
// above the 227 KB a Hopper block may use; 64 x 64 tiles of q, k and v
// in float32 (rows padded by 4 floats so 16-byte row reads hit distinct
// banks) plus the 64 x 64 probability tile take 212 KB at HD 256, one
// block per SM. Each thread owns a 4 x 4 patch of the score tile (rows
// 4*ty.., columns tx + 16*j) and the same 4 rows x HD/16 columns of the
// output accumulator in registers; a row's max and sum are reduced over
// the 16 threads that share it with warp shuffles. Causal tiles are
// issued heaviest first (the last q tile first).

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// Copy rows [r0, r0 + ROWS) of a (n_rows, HD) matrix into shared memory
// as float32 with row stride LD, times `scale`; rows past n_rows are 0.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(float* sm, const T* g, int r0,
                                      int n_rows, float scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = HD / V;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * V;
    float vals[V];
    if (r0 + r < n_rows) {
      load16(g + static_cast<size_t>(r0 + r) * HD + c, vals);
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
    float* dst = sm + r * LD + c;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ + 2 * BK) * (HD + 4) + BK * (BQ + 4));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int skv, int g, int causal, int window, float softcap,
                     int q_offset, float scale) {
  constexpr int LD = HD + 4;      // padded row stride of q / k / v tiles
  constexpr int LDP = BQ + 4;     // row stride of the transposed P tile
  constexpr int NC = HD / 16;     // output columns per thread
  constexpr bool V4 = (HD % 64) == 0;  // columns owned as float4 runs
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;       // sP[key][row]

  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int bkv = bh / g;
  const T* qg = q + static_cast<size_t>(bh) * sq * HD;
  const T* kg = k + static_cast<size_t>(bkv) * skv * HD;
  const T* vg = v + static_cast<size_t>(bkv) * skv * HD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;        // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;

  stage<T, HD, BQ, LD>(sQ, qg, q0, sq, scale);

  // Keys any row of this tile can see.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kb0 = (k_begin / BK) * BK; kb0 < k_end; kb0 += BK) {
    __syncthreads();              // the previous tile's readers are done
    stage<T, HD, BK, LD>(sK, kg, kb0, skv, 1.f);
    stage<T, HD, BK, LD>(sV, vg, kb0, skv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kb0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tx + 16 * j) * LDP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sP + kk * LDP + 4 * ty);
      const float* vrow = sV + kk * LD;
      if constexpr (V4) {
#pragma unroll
        for (int jj = 0; jj < HD / 64; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * tx + 64 * jj);
          const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * jj + e] = fmaf(p.x, ve[e], acc[0][4 * jj + e]);
            acc[1][4 * jj + e] = fmaf(p.y, ve[e], acc[1][4 * jj + e]);
            acc[2][4 * jj + e] = fmaf(p.z, ve[e], acc[2][4 * jj + e]);
            acc[3][4 * jj + e] = fmaf(p.w, ve[e], acc[3][4 * jj + e]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ve = vrow[tx + 16 * c];
          acc[0][c] = fmaf(p.x, ve, acc[0][c]);
          acc[1][c] = fmaf(p.y, ve, acc[1][c]);
          acc[2][c] = fmaf(p.z, ve, acc[2][c]);
          acc[3][c] = fmaf(p.w, ve, acc[3][c]);
        }
      }
    }
  }

  T* og = o + static_cast<size_t>(bh) * sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = V4 ? 4 * tx + 64 * (c / 4) + (c % 4) : tx + 16 * c;
      store_out(og + static_cast<size_t>(row) * HD + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(int bh, int sq, int skv, int g, int causal, int window,
                   float softcap, int q_offset, float scale, const void* q,
                   const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, g, causal,
      window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, int bh, int sq, int skv, int g, int causal,
                     int window, float softcap, int q_offset, float scale,
                     const void* q, const void* k, const void* v, void* o,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 32: return launch<T, 32>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 64: return launch<T, 64>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 128: return launch<T, 128>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 256: return launch<T, 256>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. window <= 0: no window; softcap <= 0: no
// softcap. Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int flash_attention_fwd(int dtype, int bh, int bkv, int sq, int skv, int hd,
                        int causal, int window, float softcap, int q_offset,
                        float scale, const void* q, const void* k,
                        const void* v, void* o, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv != 0 || bh > 65535 || sq <= 0 ||
      skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = bh / bkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(hd, bh, sq, skv, g, causal, window, softcap,
                            q_offset, scale, q, k, v, o, s)
          : dtype == 1 ? dispatch<__nv_bfloat16>(hd, bh, sq, skv, g, causal,
                                                 window, softcap, q_offset,
                                                 scale, q, k, v, o, s)
                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
