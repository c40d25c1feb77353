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
// tf32::flash_fwd_tf32, bfloat16 runs tc::flash_fwd_tc; both on the
// tensor cores with float32 sums, the bfloat16 one rounding its output
// once.
// A query row that sees no key (possible only with q_offset) is 0.
//
// What bounds it: at the prefill shapes of gemma2-2b (HD 256, S in the
// thousands) the work is 4*HD flops per visible (q, k) pair against
// 4*S*HD bytes per head, so it is bound by arithmetic: the tensor cores
// (495 TFLOP/s TF32, 989 bfloat16, dense) and, beside them, the float32
// softmax (tanh, exp) on the CUDA cores and special-function units.
//
// float32 (tf32::flash_fwd_tf32), on the tensor cores as 3 x TF32. One
// TF32 product (10 mantissa bits) moves a score by about 1e-3 and misses
// the float32 gate (1e-4); so every operand x is split into two TF32
// terms, big = tf32(x) and small = tf32(x - big), and each product is
// small x big + big x small + big x big (small x small, about 2^-22 of a
// term, is dropped): close to float32 accuracy at three times the
// products, 165 TFLOP/s of counted work at the 495 TFLOP/s peak against
// the CUDA cores' 67. Chosen over three bfloat16 terms (six products, the
// same rate) because it needs two stored terms per operand, not three,
// and Q alone fills most of the shared memory. One block is one
// warpgroup (128 threads) with BQ = 64 q rows, walking BK = 32 key tiles
// as the bfloat16 kernel does (tiles outside the causal / window view
// skipped).
//  - S = Q K^T: wgmma m64n32k8 TF32, both operands K-major from shared
//    memory (TF32 takes no other layout), HD / 8 steps of three
//    products. Q is scaled by 1/sqrt(HD) in float32 before the split, as
//    the plain version scales it. The tensor cores' float32 sums round
//    toward zero, an error that grows with the size of the sum and the
//    number of steps into it (summed in one accumulator on an H100, the
//    softcap case's scores, about N(0, 40^2), moved the output by
//    1.1e-4, past the gate): the
//    cross products go to an accumulator of their own (2^-10 of the
//    scores), big x big to a fresh one per 128 head-dim columns, and those
//    sums are added on the CUDA cores (round to nearest).
//  - Softcap, mask (-2e38) and the online softmax in float32 registers,
//    as in the bfloat16 kernel (ex2, the softcap's tanh from one ex2).
//  - O += P V: P split in registers into the TF32 A fragments (three
//    register-A wgmma m64n64k8 per 8 keys and 64 output columns), summed
//    per tile in a fresh accumulator and added into O on the CUDA cores,
//    for the same reason (in O itself, the truncation grows with the
//    keys: gemma2-2b's prefill logits moved by 2.4e-4). TF32's
//    B operand must be K-major, so V is stored transposed (HD rows of 32
//    keys); and since a thread's scores hold keys 2c, 2c + 1 where the A
//    fragment wants columns c, c + 4, each 8 keys of V^T are stored in
//    the order 0, 2, 4, 6, 1, 3, 5, 7, so no score moves between threads.
//  - Shared memory: Q (big, small) 2 x 64 x HD x 4 bytes, one (big,
//    small) pair of 2 x 32 x HD x 4 bytes that holds the K tile and then
//    the V^T tile, and one raw float32 tile (32 x HD x 4) that cp.async
//    fills under the products: V under S = Q K^T and the softmax, the
//    next K under P V. Each raw tile is split into the pair by a pass
//    through registers (V transposed on the way). 225 KB at HD 256, one
//    block per SM (HD 128: 113 KB). HD < 64 is padded to 64 with zeros.
//  - Registers at HD 256: O is 64 x 256 float32 = 128 per thread, the
//    three score accumulators 48, P's two terms 32 and a tile's P V
//    block 32; counts and spills per HD are in PERF.md.
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

// ------------------------------------ float32, tensor cores (3 x TF32)

namespace tf32 {

constexpr int BQ = 64;    // q rows per block: one warpgroup
constexpr int BK = 32;    // keys per tile
constexpr int NT = 128;
constexpr int FLUSH = 128;  // head-dim columns per fresh big x big sum

template <int HD>
struct Tiles {
  static constexpr int DP = HD < 64 ? 64 : HD;   // padded row width
  static constexpr int Q_TERM = BQ * DP * 4;     // one term of Q
  static constexpr int KV_TERM = BK * DP * 4;    // one K, V^T or raw tile
  // Q (big, small); one (big, small) pair that holds the K tile and then
  // the V^T tile; the raw float32 tile the next operand streams into;
  // slack to align the base to 1024 bytes.
  static constexpr int SMEM = 2 * Q_TERM + 3 * KV_TERM + 1024;
};

// x = big + small, each TF32: big = tf32(x), small = tf32(x - big)
// (x - big is exact in float32).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void st_shared4(uint32_t addr,
                                           const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Byte offset of 16-byte chunk c4 of row r in a K-major operand tile of
// ROWS rows: 32-column blocks of ROWS 128-byte rows, 128-byte swizzle.
template <int ROWS>
__device__ __forceinline__ uint32_t kmajor(int r, int c4) {
  return (c4 / 8) * (ROWS * 128) + sw128(r, c4 % 8);
}

// Rows [r0, r0 + BQ) of q, times `scale`, split into two TF32 terms at
// `big` and `small` in the K-major layout. Rows past n_rows and columns
// past HD are 0.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t big, uint32_t small,
                                       const float* g, int r0, int n_rows,
                                       float scale) {
  constexpr int C4 = Tiles<HD>::DP / 4;      // 16-byte chunks per row
#pragma unroll 4
  for (int it = 0; it < BQ * C4 / NT; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * NT;
    const int r = idx / C4;
    const int c4 = idx % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && 4 * c4 < HD)
      x = *reinterpret_cast<const float4*>(
          g + static_cast<size_t>(r0 + r) * HD + 4 * c4);
    uint32_t b[4], sm[4];
    split(x.x * scale, b[0], sm[0]);
    split(x.y * scale, b[1], sm[1]);
    split(x.z * scale, b[2], sm[2]);
    split(x.w * scale, b[3], sm[3]);
    const uint32_t off = kmajor<BQ>(r, c4);
    st_shared4(big + off, b);
    st_shared4(small + off, sm);
  }
}

// Keys [k0, k0 + BK) of k or v, as raw float32, into `raw` by cp.async:
// K in the K-major layout (kmajor), V row-major (BK rows of DP floats).
// Keys past n_keys and columns past HD are zero-filled.
template <int HD, bool KMAJOR>
__device__ __forceinline__ void fetch_raw(uint32_t raw, const float* g,
                                          int k0, int n_keys) {
  constexpr int C4 = Tiles<HD>::DP / 4;
#pragma unroll 4
  for (int it = 0; it < BK * C4 / NT; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * NT;
    const int r = idx / C4;
    const int c4 = idx % C4;
    const bool ok = k0 + r < n_keys && 4 * c4 < HD;
    const float* src = g + (ok ? static_cast<size_t>(k0 + r) * HD + 4 * c4
                               : 0);
    cp_async16(raw + (KMAJOR ? kmajor<BK>(r, c4) : 16 * idx), src,
               ok ? 16 : 0);
  }
}

// The raw K tile, already in the K-major layout, split in place of its
// layout into `big` and `small`.
template <int HD>
__device__ __forceinline__ void split_k(uint32_t big, uint32_t small,
                                        uint32_t raw) {
#pragma unroll 2
  for (int it = 0; it < Tiles<HD>::KV_TERM / 16 / NT; ++it) {
    const uint32_t off = 16 * (threadIdx.x + it * NT);
    const float4 x = ld_shared4(raw + off);
    uint32_t b[4], sm[4];
    split(x.x, b[0], sm[0]);
    split(x.y, b[1], sm[1]);
    split(x.z, b[2], sm[2]);
    split(x.w, b[3], sm[3]);
    st_shared4(big + off, b);
    st_shared4(small + off, sm);
  }
}

// The raw row-major V tile as V^T, split into `big` and `small`: DP rows
// (one per head-dim column) of BK keys, 128 bytes under the 128-byte
// swizzle (the K-major B operand of P V). Within each group of 8 keys
// the positions hold keys 0, 2, 4, 6, 1, 3, 5, 7: the order in which a
// thread's score accumulators fill the TF32 A fragment (see the P V
// step), so no score moves between threads.
template <int HD>
__device__ __forceinline__ void split_vt(uint32_t big, uint32_t small,
                                         uint32_t raw) {
  constexpr int DP = Tiles<HD>::DP;
#pragma unroll 2
  for (int it = 0; it < DP * 8 / NT; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * NT;
    const int d = idx % DP;
    const int j = idx / DP;         // chunk: keys 8 (j / 2) + j % 2 + 2e
    uint32_t b[4], sm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * (j >> 1) + (j & 1) + 2 * e;
      split(ld_shared(raw + 4 * (key * DP + d)), b[e], sm[e]);
    }
    const uint32_t off = sw128(d, j);
    st_shared4(big + off, b);
    st_shared4(small + off, sm);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int sq,
                   int skv, int g, int causal, int window, float softcap,
                   int q_offset, float scale) {
  using TL = Tiles<HD>;
  constexpr int DP = TL::DP;
  constexpr int NCB = DP / 64;    // 64-column output blocks
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQb = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQs = sQb + TL::Q_TERM;
  const uint32_t sB = sQs + TL::Q_TERM;     // K tile, then V^T tile
  const uint32_t sS = sB + TL::KV_TERM;
  const uint32_t sR = sS + TL::KV_TERM;     // the raw tile streaming in

  const int bh = blockIdx.x;
  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int bkv = bh / g;
  const float* qg = q + static_cast<size_t>(bh) * sq * HD;
  const float* kg = k + static_cast<size_t>(bkv) * skv * HD;
  const float* vg = v + static_cast<size_t>(bkv) * skv * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;             // rows 16 warp + gr (+ 8)
  const int gc = lane & 3;              // columns 8n + 2 gc (+ 1)

  // Keys any row of the block can see, as whole tiles.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int ntiles = k_end > kt0 * BK ? (k_end - kt0 * BK + BK - 1) / BK : 0;
  // This thread's two rows, as absolute positions.
  const int pos0 = q_first + 16 * warp + gr;
  const int pos1 = pos0 + 8;
  const bool capped = softcap > 0.f;
  const float inv_cap = capped ? 1.f / softcap : 0.f;

  if (ntiles > 0) fetch_raw<HD, true>(sR, kg, kt0 * BK, skv);
  cp_async_commit();
  // Q scaled in float32 (as the plain version scales it) and then split.
  load_q<HD>(sQb, sQs, qg, q0, sq, scale);

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kb0 = (kt0 + it) * BK;
    // The raw K tile has landed, and every warp's P V reads of the
    // (big, small) pair are done: split K into it.
    cp_async_wait<0>();
    __syncthreads();
    split_k<HD>(sB, sS, sR);
    fence_proxy_async();
    __syncthreads();
    // V streams in under S = Q K^T and the softmax.
    fetch_raw<HD, false>(sR, vg, kb0, skv);
    cp_async_commit();

    // S = Q K^T as three TF32 products per 8 columns of the head dim:
    // small x big, big x small, big x big (small x small, about 2^-22 of
    // a term, is left out). The tensor cores' float32 sums round toward
    // zero, an error that grows with the sum and the number of steps
    // into it: the two small cross products go to their own accumulator
    // c (2^-10 of the scores), and big x big to a fresh one (t) for each
    // FLUSH columns, added into s on the CUDA cores (round to nearest).
    float s[16], t[16], c[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
    for (int blk = 0; blk < (DP + FLUSH - 1) / FLUSH; ++blk) {
      fence_regs(t);
      fence_regs(c);
      wgmma_fence();
#pragma unroll
      for (int kk = (FLUSH / 8) * blk; kk < min(DP, FLUSH * (blk + 1)) / 8;
           ++kk) {
        const uint32_t qa = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
        const uint32_t ka = (kk / 4) * (BK * 128) + (kk % 4) * 32;
        const uint64_t qb = desc_sw128(sQb + qa, 16, 1024);
        const uint64_t kb = desc_sw128(sB + ka, 16, 1024);
        wgmma_tf32_ss(t, qb, kb, kk > (FLUSH / 8) * blk);
        wgmma_tf32_ss(c, desc_sw128(sQs + qa, 16, 1024), kb, kk > 0);
        wgmma_tf32_ss(c, qb, desc_sw128(sS + ka, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += t[i];
    }
    fence_regs(c);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] += c[i];

    // Softcap, mask and the online softmax in float32 (exponentials on
    // the special-function unit, as exp2 of log2(e)-scaled differences).
    const bool inside = kb0 + BK <= skv &&
                        (!causal || kb0 + BK - 1 <= q_first) &&
                        (window <= 0 || kb0 > q_last - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (inside) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float xc = cap_tanh(s[i] * inv_cap, softcap);
        s[i] = capped ? xc : s[i];
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
      for (int i = 0; i < 16; ++i) {
        const float xc = cap_tanh(s[i] * inv_cap, softcap);
        const float x = capped ? xc : s[i];
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
    for (int i = 0; i < 16; ++i) {
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

    // The raw V tile has landed, and every warp's S reads of the pair
    // are done: split V^T into it, then stream the next K tile in under
    // P V.
    cp_async_wait<0>();
    __syncthreads();
    split_vt<HD>(sB, sS, sR);
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < ntiles) fetch_raw<HD, true>(sR, kg, kb0 + BK, skv);
    cp_async_commit();

    // P = P_big + P_small as the TF32 A fragments of the four 8-key
    // steps. A thread's scores of 8 keys sit at keys 2 gc and 2 gc + 1
    // of rows gr and gr + 8; the fragment wants columns gc and gc + 4 of
    // those rows, so column c holds key 2c (c < 4) or 2 (c - 4) + 1, and
    // the V^T tile is stored in that key order (split_vt).
    uint32_t pb[4][4], pl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      split(s[4 * n + 0], pb[n][0], pl[n][0]);
      split(s[4 * n + 2], pb[n][1], pl[n][1]);
      split(s[4 * n + 1], pb[n][2], pl[n][2]);
      split(s[4 * n + 3], pb[n][3], pl[n][3]);
      fence_regs(pb[n]);
      fence_regs(pl[n]);
    }

    // O += P V: small x big, big x small, big x big per 8 keys, summed
    // for the tile's 32 keys in a fresh accumulator per 64 output columns
    // and added into O on the CUDA cores, so O takes one rounded-to-
    // nearest add per tile instead of twelve truncating ones (in one
    // accumulator the truncation grows with the keys: logits of gemma2's
    // 26 layers moved by 2.4e-4 at 6000 tokens on an H100).
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      float pv[32];
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t va = cb * (64 * 128) + n * 32;
        const uint64_t vb = desc_sw128(sB + va, 16, 1024);
        wgmma_tf32_rs(pv, pl[n], vb, n > 0);
        wgmma_tf32_rs(pv, pb[n], desc_sw128(sS + va, 16, 1024), 1);
        wgmma_tf32_rs(pv, pb[n], vb, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] += pv[i];
    }
  }
  cp_async_wait<0>();   // nothing left in flight

  // A row that saw no visible key (possible only with q_offset) has m
  // still at NEG_INF: it is written as 0, like the plain version's.
  float* og = o + static_cast<size_t>(bh) * sq * HD;
  const float inv0 = m0 == NEG_INF ? 0.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = m1 == NEG_INF ? 0.f : 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + 16 * warp + gr;
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
        *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * HD + col) =
            make_float2(acc[cb][4 * n + 2 * h] * inv,
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
  auto kernel = flash_fwd_tf32<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, g,
      causal, window, softcap, q_offset, scale);
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

}  // namespace tf32

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
  // A row that saw no visible key (possible only with q_offset): 0.
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * sq * HD;
  const float inv0 = m0 == NEG_INF ? 0.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = m1 == NEG_INF ? 0.f : 1.f / fmaxf(l1, 1e-30f);
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
          ? tf32::dispatch(hd, bh, sq, skv, g, causal, window, softcap,
                           q_offset, scale, q, k, v, o, s)
          : dtype == 1 ? tc::dispatch(hd, bh, sq, skv, g, causal, window,
                                      softcap, q_offset, scale, q, k, v, o, s)
                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
