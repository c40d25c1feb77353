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
// the type). HD is one of 16, 32, 64, 128, 256. float32 runs
// flash_fwd_kernel, bfloat16 runs tc::flash_fwd_tc; both compute in
// float32 and round the output once.
//
// What bounds it: at the prefill shapes of gemma2-2b (HD 256, S in the
// thousands) the work is 4*HD flops per visible (q, k) pair against
// 4*S*HD bytes per head, so it is bound by arithmetic: the float32
// kernel by the CUDA cores (67 TFLOP/s), the bfloat16 one by the tensor
// cores (989 TFLOP/s dense) and, beside them, the float32 softmax
// (tanh, exp) on the CUDA cores and special-function units.
//
// float32 (flash_fwd_kernel). Every product in float32 on the CUDA
// cores (no tensor cores, no TMA): the float32 path must agree with the
// plain version to ~1e-5, which TF32 tensor cores would not. One thread
// block of 256 threads computes a BQ = 64 row tile of one q row and
// walks the BK = 64 key tiles it can see: key tiles entirely above the
// causal diagonal or entirely left of the window are never loaded (the
// Pallas kernel skips them too). Tiles: the TPU's 128 x 128 blocks at HD
// 256 need q + k + v = 384 KB in float32, far above the 227 KB a Hopper
// block may use; 64 x 64 tiles of q, k and v in float32 (rows padded by
// 4 floats so 16-byte row reads hit distinct banks) plus the 64 x 64
// probability tile take 212 KB at HD 256, one block per SM. Each thread
// owns a 4 x 4 patch of the score tile (rows 4*ty.., columns tx + 16*j)
// and the same 4 rows x HD/16 columns of the output accumulator in
// registers; a row's max and sum are reduced over the 16 threads that
// share it with warp shuffles. Causal tiles are issued heaviest first
// (the last q tile first).
//
// bfloat16 (tc::flash_fwd_tc), on the tensor cores with float32
// semantics. One block of two warpgroups (256 threads) takes BQ = 128 q
// rows, 64 per warpgroup, and walks BK = 64 key tiles as above (a
// warpgroup also skips the tiles that none of its own rows can see).
//  - S = Q K^T: wgmma m64n64k16 (bf16 x bf16 -> f32), HD / 16 steps,
//    both operands K-major from shared memory. A bf16 x bf16 product is
//    exact in float32, so S is the plain float32 einsum up to summation
//    order; the 1/sqrt(HD) scale is applied to the float32 scores.
//  - Softcap, mask (-2e38) and the online softmax in float32 registers:
//    the accumulator layout gives each thread two rows, reduced over the
//    four lanes that share them; exponentials on the special-function
//    unit (ex2), the softcap's tanh from one ex2, and tiles that every
//    row sees whole skip the mask in a loop of their own, so the
//    unrolled loops hold no branch. Both warpgroups meet at two block
//    barriers per tile.
//  - O += P V as P_hi V + P_lo V with P_hi = bf16(p), P_lo = bf16(p -
//    P_hi): two register-A wgmmas per 16 keys and 64 output columns, V
//    the MN-major operand (its keys x HD rows as stored, the transpose
//    bit). One bf16 P would carry a relative error of 2^-9 into every
//    term, and outputs near 0 would miss the bf16 gate's atol of 1e-5;
//    the pair leaves about 2^-17. It costs 1.5x the bound's operations.
//  - Shared memory: Q (BQ x HD) and a two-stage ring of K and V tiles
//    (64 x HD each), all bf16 in 64-column blocks of 128-byte rows under
//    the 128-byte swizzle the wgmma descriptors name, loaded by cp.async
//    (16 bytes a thread, rows past Skv zero-filled, so 0 * garbage never
//    reaches P V); tile t + 1 loads while tile t computes. HD 256: 64 +
//    128 KB, one block per SM; HD < 64 pads rows to 64 zeros.
//  - Registers at HD 256: O is 64 x 256 float32 = 128 per thread, S 32,
//    P_hi / P_lo 32, one block of 256 threads per SM
//    (__launch_bounds__(256, 1)); counts and spills per HD are in
//    PERF.md (ptxas -v).

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// Copy rows [r0, r0 + ROWS) of a (n_rows, HD) matrix into shared memory
// as float32 with row stride LD, times `scale`; rows past n_rows are 0.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(float* sm, const float* g, int r0,
                                      int n_rows, float scale) {
  constexpr int V = 4;
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

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int sq,
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
  const float* qg = q + static_cast<size_t>(bh) * sq * HD;
  const float* kg = k + static_cast<size_t>(bkv) * skv * HD;
  const float* vg = v + static_cast<size_t>(bkv) * skv * HD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;        // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;

  stage<HD, BQ, LD>(sQ, qg, q0, sq, scale);

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
    stage<HD, BK, LD>(sK, kg, kb0, skv, 1.f);
    stage<HD, BK, LD>(sV, vg, kb0, skv, 1.f);
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

  float* og = o + static_cast<size_t>(bh) * sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = V4 ? 4 * tx + 64 * (c / 4) + (c % 4) : tx + 16 * c;
      og[static_cast<size_t>(row) * HD + col] = acc[i][c] * inv;
    }
  }
}

template <int HD>
cudaError_t launch(int bh, int sq, int skv, int g, int causal, int window,
                   float softcap, int q_offset, float scale, const void* q,
                   const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, g, causal,
      window, softcap, q_offset, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bfloat16, tensor cores

namespace tc {

constexpr int BQ = 128;   // q rows per block: two warpgroups of 64
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;

template <int HD>
struct Tiles {
  static constexpr int DP = HD < 64 ? 64 : HD;   // padded row width
  static constexpr int NCB = DP / 64;            // 64-column blocks
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;   // one K or V tile
  // Q, two stages of (K, V), and slack to align the base to 1024 bytes.
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

// Rows [r0, r0 + ROWS) of a (n_rows, HD) bfloat16 matrix into a tile of
// 64-column blocks of ROWS swizzled 128-byte rows each, by cp.async;
// rows past n_rows are zero-filled (nothing is read for them).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g, int r0,
                                          int n_rows) {
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * NT;
    if (N % NT != 0 && i >= N) break;
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = r0 + r < n_rows;
    const __nv_bfloat16* src =
        g + static_cast<size_t>(ok ? r0 + r : 0) * HD + c * 8;
    cp_async16(dst + (c / 8) * (ROWS * 128) + sw128(r, c % 8), src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int sq, int skv, int g,
                 int causal, int window, float softcap, int q_offset,
                 float scale) {
  using TL = Tiles<HD>;
  constexpr int NCB = TL::NCB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + TL::Q_BYTES;   // stage s: K at s * 2 tiles, V after

  const int bh = blockIdx.x;
  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int bkv = bh / g;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * sq * HD;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bkv) * skv * HD;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bkv) * skv * HD;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup: rows 64 wg ..
  const int warp = (tid >> 5) & 3;      // warp in the warpgroup
  const int lane = tid & 31;
  const int gr = lane >> 2;             // rows 16 warp + gr (+ 8)
  const int gc = lane & 3;              // columns 8n + 2 gc (+ 1)

  if constexpr (HD < 64) {
    // Padding columns of the 64-wide rows are never loaded: zero them
    // (the PV product reads them into output columns that are dropped).
    for (uint32_t off = tid * 16; off < TL::Q_BYTES + 4 * TL::KV_BYTES;
         off += NT * 16)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       sQ + off),
                   "r"(0), "r"(0), "r"(0), "r"(0)
                   : "memory");
    __syncthreads();
  }

  // Keys any row of the block can see, as whole tiles.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int ntiles = k_end > kt0 * BK ? (k_end - kt0 * BK + BK - 1) / BK : 0;
  // This warpgroup's rows, and the keys they can see.
  const int w_row0 = q0 + 64 * wg;
  const bool w_live = w_row0 < sq;
  const int w_first = q_offset + w_row0;
  const int w_last = q_offset + min(w_row0 + 64, sq) - 1;
  const int w_end = causal ? min(skv, w_last + 1) : skv;
  const int w_begin = window > 0 ? max(0, w_first - window + 1) : 0;
  // This thread's two rows, as absolute positions.
  const int pos0 = w_first + 16 * warp + gr;
  const int pos1 = pos0 + 8;
  const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;

  load_tile<HD, BQ>(sQ, qg, q0, sq);
  if (ntiles > 0) {
    load_tile<HD, BK>(sKV, kg, kt0 * BK, skv);
    load_tile<HD, BK>(sKV + TL::KV_BYTES, vg, kt0 * BK, skv);
  }
  cp_async_commit();

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kb0 = (kt0 + it) * BK;
    const uint32_t sK = sKV + (it & 1) * 2 * TL::KV_BYTES;
    const uint32_t sV = sK + TL::KV_BYTES;
    if (it + 1 < ntiles) {   // the next tile streams in under this one
      const uint32_t nK = sKV + ((it + 1) & 1) * 2 * TL::KV_BYTES;
      load_tile<HD, BK>(nK, kg, kb0 + BK, skv);
      load_tile<HD, BK>(nK + TL::KV_BYTES, vg, kb0 + BK, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    if (w_live && kb0 < w_end && kb0 + BK > w_begin) {
      // S = Q K^T on the tensor cores (bf16 x bf16 products are exact
      // in float32), then the scale on the float32 scores.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qa = sQ + (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                            (kk % 4) * 32;
        const uint32_t ka = sK + (kk / 4) * (BK * 128) + (kk % 4) * 32;
        wgmma_ss(s, desc_sw128(qa, 16, 1024), desc_sw128(ka, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Softcap, mask and the online softmax in float32 (exponentials
      // on the special-function unit, as exp2 of log2(e)-scaled
      // differences).
      const bool inside = kb0 + BK <= skv &&
                          (!causal || kb0 + BK - 1 <= w_first) &&
                          (window <= 0 || kb0 > w_last - window);
      // Two branch-free loops: tiles inside every row's view, and the
      // rest with the mask.
      float mx0 = NEG_INF, mx1 = NEG_INF;
      const bool capped = softcap > 0.f;
      if (inside) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float xc = cap_tanh(s[i] * scale_cap, softcap);
          s[i] = capped ? xc : s[i] * scale;
          if (i & 2)
            mx1 = fmaxf(mx1, s[i]);
          else
            mx0 = fmaxf(mx0, s[i]);
        }
      } else {
        const int lim0 = causal ? min(pos0 + 1, skv) : skv;   // keys < lim
        const int lim1 = causal ? min(pos1 + 1, skv) : skv;
        const int low0 = window > 0 ? pos0 - window : -1;     // keys > low
        const int low1 = window > 0 ? pos1 - window : -1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float xc = cap_tanh(s[i] * scale_cap, softcap);
          const float x = capped ? xc : s[i] * scale;
          const int kpos = kb0 + 8 * (i / 4) + 2 * gc + (i & 1);
          const bool ok = (i & 2) ? (kpos < lim1 && kpos > low1)
                                  : (kpos < lim0 && kpos > low0);
          s[i] = ok ? x : NEG_INF;
          if (i & 2)
            mx1 = fmaxf(mx1, s[i]);
          else
            mx0 = fmaxf(mx0, s[i]);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2((m0 - mn0) * LOG2E), a1 = ex2((m1 - mn1) * LOG2E);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2((s[i] - ((i & 2) ? mn1 : mn0)) * LOG2E);
        if (i & 2)
          ps1 += s[i];
        else
          ps0 += s[i];
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
      }
      l0 = a0 * l0 + ps0;
      l1 = a1 * l1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[cb][i] *= (i & 2) ? a1 : a0;
        fence_regs(acc[cb]);
      }

      // P = P_hi + P_lo, two bfloat16 terms (about 2^-17 relative
      // together; one bfloat16 P alone carries 2^-9 into every term),
      // as the m16k16 A fragments of the four 16-key steps: the score
      // accumulator's layout is already that fragment's.
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(h);
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
          pl[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }

      // O += P_hi V + P_lo V, V as the MN-major operand (its rows are
      // the keys, its 64-column blocks N).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          const uint64_t dv =
              desc_sw128(sV + cb * (BK * 128) + kk * 2048, 1024, 1024);
          wgmma_rs(acc[cb], ph[kk], dv);
          wgmma_rs(acc[cb], pl[kk], dv);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    }
    __syncthreads();   // every read of this stage is done
  }
  cp_async_wait<0>();   // nothing left in flight (no tile: Q's group)

  if (!w_live) return;
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * sq * HD;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = w_row0 + 16 * warp + gr;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * cb + 8 * n + 2 * gc;
      if (col >= HD) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= sq) continue;
        const float inv = h ? inv1 : inv0;
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(row) *
                                                    HD + col) =
            __floats2bfloat162_rn(acc[cb][4 * n + 2 * h] * inv,
                                  acc[cb][4 * n + 2 * h + 1] * inv);
      }
    }
}

template <int HD>
cudaError_t launch(int bh, int sq, int skv, int g, int causal, int window,
                   float softcap, int q_offset, float scale, const void* q,
                   const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  const int smem = Tiles<HD>::SMEM;
  auto kernel = flash_fwd_tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      sq, skv, g, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(int hd, int bh, int sq, int skv, int g, int causal,
                     int window, float softcap, int q_offset, float scale,
                     const void* q, const void* k, const void* v, void* o,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 32: return launch<32>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 64: return launch<64>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 128: return launch<128>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 256: return launch<256>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

cudaError_t dispatch(int hd, int bh, int sq, int skv, int g, int causal,
                     int window, float softcap, int q_offset, float scale,
                     const void* q, const void* k, const void* v, void* o,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 32: return launch<32>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 64: return launch<64>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 128: return launch<128>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
    case 256: return launch<256>(bh, sq, skv, g, causal, window, softcap, q_offset, scale, q, k, v, o, s);
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
          ? dispatch(hd, bh, sq, skv, g, causal, window, softcap, q_offset,
                     scale, q, k, v, o, s)
          : dtype == 1 ? tc::dispatch(hd, bh, sq, skv, g, causal, window,
                                      softcap, q_offset, scale, q, k, v, o, s)
                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
