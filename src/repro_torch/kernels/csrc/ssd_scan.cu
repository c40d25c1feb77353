// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_bh
// (body _ssd_kernel). Per chunk of Q <= 128 tokens of one (batch, head)
// row, with a_cum = cumsum(a) over the chunk:
//   L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0 (selected: the
//             upper triangle's exponent may overflow to inf, and a 0/1
//             mask multiplied in would turn inf into NaN);
//   y       = (C B^T o L) x + exp(a_cum) o (C S^T);
//   S'      = S exp(a_cum[-1]) + (x o w)^T B,  w = exp(a_cum[-1] - a_cum),
// with the (P, N) float32 state S carried from chunk to chunk, starting at
// s0, as the Pallas body computes it (preferred_element_type=float32).
//
// Layout: x (BH, L, P), a (BH, L) float32, B / C (BH, L, N), s0 (BH, P, N)
// float32 or none; y (BH, L, P) in x's type, sT (BH, P, N) float32. x, B
// and C share the type (float32 or bfloat16); L is a multiple of Q; P and
// N are multiples of 8, N <= 128.
//
// What bounds it: at mamba2-130m's widths (P 64, N 128, Q 128) a chunk is
// 2Q(QN + QP + 2NP) = 10.5 MFLOP of counted work against 80 KB of
// bfloat16 inputs (100 KB at batch 8 with the outputs), so bfloat16 is
// bound by the bytes once the products run on the tensor cores; float32,
// whose products must run as 3 x TF32 to hold 1e-4, is bound by the
// tensor cores' TF32 rate (495 TFLOP/s, a third of it in counted work).
//
// Design: one launch per call; one block (two warpgroups, 256 threads)
// per chunk of one row and 64 head-dim columns (a row of P > 64 is split
// into independent 64-column rows: the state's rows never mix), all four
// products on the tensor cores with wgmma, and the state handed from
// chunk to chunk of a row through global memory by a chained scan:
//  - A block takes a ticket from a counter; ticket t is chunk t / rows of
//    row t % rows (chunk-major), so a block only ever waits on a ticket
//    handed out before its own, whose block is already resident: the
//    chain cannot deadlock. The block computes what needs no state first:
//    C B^T o L, (C B^T o L) x and its chunk's contribution (x o w)^T B.
//    Only then does it wait for its row's flag to say the chunk's start
//    state is in the row's slot (sT itself, so no scratch), reads it
//    (L2 only: ld.global.cg, since L1 is not coherent; every load issued
//    before any store), writes S exp(total) + contribution over it, and
//    publishes the flag (a release after a barrier) for the next chunk;
//    the last chunk's write is the final state. Each chunk's start state
//    is written once and read once; the output pass C S^T runs after the
//    publish, off the chain. No (BH, L / Q, P, N) scratch of chunk
//    states, and no pass that reads and rewrites one.
//  - The ticket counter and the flags live in a per-(device, stream)
//    buffer (ssd_scan.py); the block that takes the last ticket resets the
//    counter and the last chunk of each row resets its flag, so they are
//    zero between launches.
//  - The upper triangle of L is selected, never multiplied, and the first
//    warpgroup (rows 0-63) skips the columns 64-127 of C B^T and of the
//    (C B^T o L) x product, which it cannot see.
//  - Q < 128, N < 64 NKB and the head-dim columns past P are zero in
//    shared memory (cp.async zero fill), never read out of bounds.
//  - A wait longer than 20 s traps (the launch fails) instead of hanging.
//
// bfloat16 (bf::ssd_bf16), wgmma m64n64k16 with float32 sums:
//  - C B^T: one term, C and B (K-major, 128-byte swizzle) from shared
//    memory: a bf16 x bf16 product is exact in float32.
//  - (C B^T o L) x: L selected in the accumulator, the float32 product
//    split in registers into hi = bf16(v) and lo = bf16(v - hi), the two
//    register-A operands of wgmma; x the MN-major B operand.
//  - (x o w)^T B: x o w built in registers from the x tile and split into
//    hi + lo, register A; B (stored once) the MN-major B operand.
//  - C S^T: S split into hi + lo when staged (in B's space, free by
//    then), both operands K-major from shared memory.
//  One bf16 term on any of the three float32 operands misses the gates
//  (tests/test_torch_tc_ssd.py). Shared memory: C, B (16 KB per 64 state
//  columns each) and x (16 KB): 80 KB at N 128, two blocks per SM.
//
// float32 (tf::ssd_tf32), 3 x TF32 on every product: each operand split
// into big = tf32(v) and small = tf32(v - big), each product small x big
// + big x small + big x big, the two cross products summed in an
// accumulator of their own (the tensor cores' float32 sums truncate; see
// flash_attention.cu) and added to big x big on the CUDA cores. TF32
// takes both shared-memory operands K-major only, so:
//  - C and B are kept raw (float32, K-major) in shared memory, loaded by
//    cp.async in one group per 32 state columns (x raw in the second
//    group), so C B^T's first piece starts while the rest lands; C's A
//    fragments, and B^T's for the contribution, are read from them and
//    split in registers (register-A wgmma m64n64k8).
//  - C B^T streams its K (state) dimension in 32-column pieces of B,
//    split into a double-buffered (big, small) pair, as the attention
//    kernel streams keys (the float32 (big, small) tiles of C and B would
//    take 256 KB); a piece waits only for its own columns to land.
//  - (C B^T o L) x: L selected, the product split in registers; x (raw
//    until C B^T is done) stored transposed and split, each 8 tokens in
//    the order 0, 2, 4, 6, 1, 3, 5, 7 in which the accumulator fills the
//    TF32 A fragment.
//  - The contribution is computed transposed, B^T (x o w) (B^T's
//    fragments from the raw B tile; (x o w)^T made in place from the
//    staged x^T, read back as big + small), and its elements are matched
//    to the state's (P, N) layout on the way out.
//  - C S^T: S split into the same region when staged.
//  Shared memory: raw C and B (32 KB per 32 state columns together), one
//  64 x 128 (big, small) region for raw x, then x^T, (x o w)^T and S (64
//  KB), and the two B pieces (32 KB): 224 KB at N 128, one block per SM.
//
// Registers (ptxas -v, sm_90a): bf::ssd_bf16 128, the cap of two blocks
// per SM (no spills at N 128; 4 bytes at N <= 64); tf::ssd_tf32 249, no
// spills. A block's a is loaded before its bulk copies are issued, and a
// thread's loads of the state before its stores: a load behind them waits
// for them.

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;        // two warpgroups
constexpr int QP = 128;        // chunk rows the tiles hold (Q <= QP)
constexpr int NMAX = 128;      // state columns the tiles hold
constexpr int PT = 64;         // head-dim columns per block
// A wait on the previous chunk longer than this is a broken chain: trap
// (the launch fails) instead of hanging the card.
constexpr unsigned long long MAX_WAIT_NS = 20000000000ull;

// ------------------------------------------------------- shared pieces

// a[t] of thread t < QP (0 past q and for the other threads), loaded
// before a block's bulk copies are issued, which it would queue behind.
__device__ __forceinline__ float load_a(const float* a, int q) {
  const int t = threadIdx.x;
  return t < QP && t < q ? a[t] : 0.f;
}

// Inclusive prefix sum of the chunk's a (v = load_a(), 0 past q) into
// acum[0, QP), by the first QP threads; wsum holds QP / 32 warp totals.
// acum[t] for t >= q is acum[q - 1], the chunk's total.
__device__ __forceinline__ void chunk_cumsum(float v, float* acum,
                                             float* wsum) {
  const int t = threadIdx.x;
  if (t < QP) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if ((t & 31) >= o) v += u;
    }
    if ((t & 31) == 31) wsum[t >> 5] = v;
  }
  __syncthreads();
  if (t < QP) {
    for (int w = 0; w < (t >> 5); ++w) v += wsum[w];
    acum[t] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

struct Chunk {
  int c;     // chunk of the row
  int row;   // (bh, 64-column head-dim tile)
};

// sync[0] hands out tickets in launch order; ticket t is chunk t / rows of
// row t % rows. The block that takes the last ticket resets the counter.
__device__ __forceinline__ Chunk take_chunk(int* sync, int rows, int nc,
                                            int* slot) {
  if (threadIdx.x == 0) {
    const int t = atomicAdd(sync, 1);
    if (t == rows * nc - 1) atomicExch(sync, 0);
    *slot = t;
  }
  __syncthreads();
  const int t = *slot;
  return {t / rows, t % rows};
}

// Wait until the row's flag says its slot holds chunk c's start state.
__device__ __forceinline__ void wait_start_state(const int* flag, int c) {
  if (threadIdx.x == 0 && c > 0) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(flag) != c) {
      __nanosleep(32);
      if (global_ns() - t0 > MAX_WAIT_NS) __trap();
    }
  }
  __syncthreads();
}

// Every thread has stored its part of chunk c + 1's start state: publish
// it (the last chunk resets the flag to 0 instead). The barrier orders the
// block's stores before thread 0's release, which is cumulative: a block
// that acquires the flag sees them all.
__device__ __forceinline__ void publish(int* flag, int c, int nc) {
  __syncthreads();
  if (threadIdx.x == 0 && nc > 1) st_release(flag, c + 1 < nc ? c + 1 : 0);
}

// Rows [0, ROWS) of a row-major matrix g (row stride ld elements) into a
// K-major tile of `width` columns by cp.async: 128-byte rows (64 bf16 or
// 32 float32) in column blocks of ROWS rows, 128-byte swizzle. Rows past
// n_rows and 16-byte chunks past n_cols are zero-filled.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* g,
                                          size_t ld, int n_rows, int n_cols,
                                          int width) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int cpr = width / V;
  for (int i = threadIdx.x; i < ROWS * cpr; i += NT) {
    const int r = i / cpr;
    const int ch = i - r * cpr;
    const bool ok = r < n_rows && ch * V < n_cols;
    cp_async16(dst + (ch >> 3) * (ROWS * 128) + sw128(r, ch & 7),
               g + (ok ? r * ld + ch * V : 0), ok ? 16 : 0);
  }
}

// ------------------------------------------------------------ bfloat16

namespace bf {

template <int NKB>   // state columns padded to 64 NKB
struct Smem {
  static constexpr int TILE = QP * 128;        // a 64-column block, QP rows
  static constexpr int C = 0;
  static constexpr int B = C + NKB * TILE;     // B, then S (hi, lo)
  static constexpr int S_TERM = NKB * 64 * 128;
  static constexpr int X = B + NKB * TILE;
  static constexpr int ACUM = X + TILE;
  static constexpr int W = ACUM + QP * 4;
  static constexpr int WSUM = W + QP * 4;
  static constexpr int TICKET = WSUM + QP / 32 * 4;
  static constexpr int BYTES = TICKET + 16 + 1024;   // + base alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (v0, v1) = hi + lo, each a bfloat16 pair: hi = bf16(v), lo = bf16(v -
// hi) (v - hi is exact in float32).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// Byte offset of element (r, k) in a K-major bfloat16 tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t kmajor(int r, int k) {
  return (k >> 6) * (ROWS * 128) + sw128(r, (k & 63) >> 3) + (k & 7) * 2;
}

template <int NKB>
__global__ void __launch_bounds__(NT, 2)
    ssd_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
             const __nv_bfloat16* __restrict__ B,
             const __nv_bfloat16* __restrict__ C,
             const float* __restrict__ s0, __nv_bfloat16* __restrict__ y,
             float* sT, int* sync, int rows, int nc, int l, int p, int n,
             int q) {
  using SM = Smem<NKB>;
  constexpr int NP = 64 * NKB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s = smem_u32(sm);
  float* acum = reinterpret_cast<float*>(sm + SM::ACUM);
  float* w = reinterpret_cast<float*>(sm + SM::W);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup
  const int warp = (tid >> 5) & 3;      // warp in the warpgroup
  const int lane = tid & 31;
  const int gr = lane >> 2;             // rows 16 warp + gr (+ 8)
  const int gc = lane & 3;              // columns 8n + 2 gc (+ 1)

  const Chunk ch = take_chunk(sync, rows, nc,
                              reinterpret_cast<int*>(sm + SM::TICKET));
  const int npt = (p + PT - 1) / PT;
  const int bh = ch.row / npt;
  const int p0 = (ch.row % npt) * PT;
  const size_t row0 = static_cast<size_t>(bh) * l +
                      static_cast<size_t>(ch.c) * q;

  const float av = load_a(a + row0, q);
  load_tile<__nv_bfloat16, QP>(s + SM::C, C + row0 * n, n, q, n, NP);
  load_tile<__nv_bfloat16, QP>(s + SM::B, B + row0 * n, n, q, n, NP);
  load_tile<__nv_bfloat16, QP>(s + SM::X, x + row0 * p + p0, p, q, p - p0,
                               64);
  cp_async_commit();
  chunk_cumsum(av, acum, reinterpret_cast<float*>(sm + SM::WSUM));
  const float total = acum[QP - 1];
  if (tid < QP) w[tid] = expf(total - acum[tid]);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // --- (C B^T o L) x, per 64-column block jb of C B^T. The first
  // warpgroup's rows (0-63) see no column past 63.
  const int i0 = 64 * wg + 16 * warp + gr;   // this thread's rows i0, +8
  float yd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yd[i] = 0.f;
  for (int jb = 0; jb <= wg; ++jb) {
    float cb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[i] = 0.f;
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t ca = s + SM::C + (kk / 4) * SM::TILE + wg * (64 * 128) +
                          (kk % 4) * 32;
      const uint32_t ba = s + SM::B + (kk / 4) * SM::TILE + jb * (64 * 128) +
                          (kk % 4) * 32;
      wgmma_ss(cb, desc_sw128(ca, 16, 1024), desc_sw128(ba, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);

    // L selected in the accumulator, the product split into two bf16
    // terms, as the m16k16 A fragments of the four 16-column steps (the
    // accumulator's layout is already that fragment's).
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 8 * (r & 1);
        const int j = 64 * jb + 16 * kk + 8 * (r >> 1) + 2 * gc;
        const int v = 8 * kk + 2 * r;
        const float ai = acum[i];
        const float m0 = i >= j ? cb[v] * __expf(ai - acum[j]) : 0.f;
        const float m1 = i > j ? cb[v + 1] * __expf(ai - acum[j + 1]) : 0.f;
        split2(m0, m1, mh[kk][r], ml[kk][r]);
      }
      fence_regs(mh[kk]);
      fence_regs(ml[kk]);
    }
    fence_regs(yd);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx =
          desc_sw128(s + SM::X + (4 * jb + kk) * 2048, 1024, 1024);
      wgmma_rs(yd, mh[kk], dx);
      wgmma_rs(yd, ml[kk], dx);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yd);
  }

  // --- the chunk's contribution (x o w)^T B, (64, 64) per warpgroup: the
  // state columns 64 wg .. (warpgroup 1 idles when N <= 64). A = (x o
  // w)^T from the x tile, split in registers, 64 tokens at a time.
  float dl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dl[i] = 0.f;
  const uint8_t* xs = sm + SM::X;
  if (wg < NKB) {
    fence_regs(dl);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      uint32_t xh[4][4], xl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pp = 16 * warp + gr + 8 * (r & 1);
          const int t = 64 * half + 16 * kk + 8 * (r >> 1) + 2 * gc;
          const float v0 = __bfloat162float(*reinterpret_cast<
              const __nv_bfloat16*>(xs + t * 128 +
                                    (((pp >> 3) ^ (t & 7)) << 4) +
                                    (pp & 7) * 2));
          const float v1 = __bfloat162float(*reinterpret_cast<
              const __nv_bfloat16*>(xs + (t + 1) * 128 +
                                    (((pp >> 3) ^ ((t + 1) & 7)) << 4) +
                                    (pp & 7) * 2));
          split2(v0 * w[t], v1 * w[t + 1], xh[kk][r], xl[kk][r]);
        }
        fence_regs(xh[kk]);
        fence_regs(xl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(
            s + SM::B + wg * SM::TILE + (4 * half + kk) * 2048, 1024, 1024);
        wgmma_rs(dl, xh[kk], db);
        wgmma_rs(dl, xl[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dl);
    }
  }

  // --- the chain: this chunk's start state S, then S exp(total) + the
  // contribution over it for the next chunk (or as the final state).
  int* flag = sync + 1 + ch.row;
  wait_start_state(flag, ch.c);
  float* slot = sT + (static_cast<size_t>(bh) * p + p0) * n;
  const float* start = ch.c > 0 ? slot
                       : s0 != nullptr
                           ? s0 + (static_cast<size_t>(bh) * p + p0) * n
                           : nullptr;
  const float decay = expf(total);
  // Every load before any store: the slot is read and written through one
  // pointer, so a store between two loads would make the second wait for
  // the first's round trip.
  float sv[32];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = 16 * warp + gr + 8 * h;
      const int nn = 64 * wg + 8 * nb + 2 * gc;
      float2 v = make_float2(0.f, 0.f);
      if (wg < NKB && p0 + pp < p && nn < n && start != nullptr)
        v = __ldcg(reinterpret_cast<const float2*>(start + pp * n + nn));
      sv[4 * nb + 2 * h] = v.x;
      sv[4 * nb + 2 * h + 1] = v.y;
    }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = 16 * warp + gr + 8 * h;
      const int nn = 64 * wg + 8 * nb + 2 * gc;
      const int v = 4 * nb + 2 * h;
      if (wg < NKB && p0 + pp < p && nn < n)
        __stcg(reinterpret_cast<float2*>(slot + pp * n + nn),
               make_float2(sv[v] * decay + dl[v],
                           sv[v + 1] * decay + dl[v + 1]));
    }
  publish(flag, ch.c, nc);

  // --- C S^T, S split into hi + lo in B's space (every read of B is
  // done: each warpgroup waited on its products before the barrier).
  if (wg < NKB) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = 16 * warp + gr + 8 * h;
        const int nn = 64 * wg + 8 * nb + 2 * gc;
        uint32_t hi, lo;
        split2(sv[4 * nb + 2 * h], sv[4 * nb + 2 * h + 1], hi, lo);
        const uint32_t off = kmajor<64>(pp, nn);
        *reinterpret_cast<uint32_t*>(sm + SM::B + off) = hi;
        *reinterpret_cast<uint32_t*>(sm + SM::B + SM::S_TERM + off) = lo;
      }
  }
  fence_proxy_async();
  __syncthreads();

  float yo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yo[i] = 0.f;
  fence_regs(yo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint64_t dc = desc_sw128(s + SM::C + (kk / 4) * SM::TILE +
                                       wg * (64 * 128) + (kk % 4) * 32,
                                   16, 1024);
    const uint32_t sa = s + SM::B + (kk / 4) * (64 * 128) + (kk % 4) * 32;
    wgmma_ss(yo, dc, desc_sw128(sa, 16, 1024), 1);
    wgmma_ss(yo, dc, desc_sw128(sa + SM::S_TERM, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(yo);

  // --- y = (C B^T o L) x + exp(a_cum) o (C S^T), rounded once.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if (i >= q) continue;
    const float e = expf(acum[i]);
    __nv_bfloat16* yr = y + (row0 + i) * p + p0;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 8 * nb + 2 * gc;
      if (p0 + col < p)
        *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(
            yd[4 * nb + 2 * h] + e * yo[4 * nb + 2 * h],
            yd[4 * nb + 2 * h + 1] + e * yo[4 * nb + 2 * h + 1]);
    }
  }
}

}  // namespace bf

// ------------------------------------------------- float32, 3 x TF32

namespace tf {

// cp.async wait with a pending-group count known only at run time (< 5).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

template <int NKB>   // state columns padded to 64 NKB
struct Smem {
  static constexpr int RAW = QP * 128;          // a 32-column block, QP rows
  static constexpr int C = 0;
  static constexpr int B = C + 2 * NKB * RAW;
  static constexpr int TERM = 64 * 128 * 4;     // 64 rows x 128 columns
  static constexpr int R1 = B + 2 * NKB * RAW;  // x^T, (x o w)^T, S: big,
                                                // then small
  static constexpr int PIECE = 64 * 128;        // 64 rows x 32 columns
  static constexpr int R2 = R1 + 2 * TERM;      // two (big, small) pieces
  static constexpr int ACUM = R2 + 4 * PIECE;
  static constexpr int W = ACUM + QP * 4;
  static constexpr int WSUM = W + QP * 4;
  static constexpr int TICKET = WSUM + QP / 32 * 4;
  static constexpr int BYTES = TICKET + 16 + 1024;   // + base alignment
};

// v = big + small, each TF32: big = tf32(v), small = tf32(v - big).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// Byte offset of element (r, k) in a K-major float32 tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t kmajor(int r, int k) {
  return (k >> 5) * (ROWS * 128) + sw128(r, (k & 31) >> 2) + (k & 3) * 4;
}

// Element (r, k) of a raw (QP, .) K-major float32 tile.
__device__ __forceinline__ float raw(const uint8_t* t, int r, int k) {
  return *reinterpret_cast<const float*>(t + kmajor<QP>(r, k));
}

// The TF32 A fragment of rows r0 + gr (+ 8) and columns k0 + gc (+ 4) of
// the raw tile (TRANS: of its transpose, rows and columns swapped), split.
template <bool TRANS>
__device__ __forceinline__ void frag_a(const uint8_t* t, int r0, int k0,
                                       int gr, int gc, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + gr + 8 * (e & 1);
    const int k = k0 + gc + 4 * (e >> 1);
    split(TRANS ? raw(t, k, r) : raw(t, r, k), big[e], small[e]);
  }
  fence_regs(big);
  fence_regs(small);
}

// Byte offset of x's row t, 16-byte chunk c4 in the raw tile: 256-byte
// rows, chunk c4 stored at c4 ^ (t % 16), so that stage_xt's reads of 16
// rows x 2 chunks per warp spread over the banks.
__device__ __forceinline__ uint32_t raw_x(int t, int c4) {
  return t * 256 + ((c4 ^ (t & 15)) << 4);
}

// x rows [0, q) (columns [0, pcols) of a 64-column head-dim tile, row
// stride ld) into the raw tile at dst by cp.async; the rest zero-filled.
__device__ __forceinline__ void fetch_x(uint32_t dst, const float* g,
                                        size_t ld, int q, int pcols) {
  for (int i = threadIdx.x; i < QP * 16; i += NT) {
    const int t = i >> 4;
    const int c4 = i & 15;
    const bool ok = t < q && 4 * c4 < pcols;
    cp_async16(dst + raw_x(t, c4), g + (ok ? t * ld + 4 * c4 : 0),
               ok ? 16 : 0);
  }
}

// The raw x tile, which lies in the small half of r1, as x^T split into
// the (big, small) K-major tiles of 64 rows at r1 and r1 + term, each 8
// tokens in the order 0, 2, 4, 6, 1, 3, 5, 7. A warp takes 16 tokens x 8
// columns, so its transposed 4-byte stores fall in 32 distinct banks.
// Every thread reads its part before the barrier, then writes.
__device__ __forceinline__ void stage_xt(uint8_t* r1, int term) {
  constexpr int IT = QP * 16 / NT;
  float4 v[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * NT;
    const int t = ((i >> 5) & 7) << 4 | (i & 31) >> 1;
    const int c4 = (i >> 8) << 1 | (i & 1);
    v[it] = *reinterpret_cast<const float4*>(r1 + term + raw_x(t, c4));
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * NT;
    const int t = ((i >> 5) & 7) << 4 | (i & 31) >> 1;
    const int c4 = (i >> 8) << 1 | (i & 1);
    const int tp = (t & ~7) | ((t & 1) << 2) | ((t & 7) >> 1);
    const float vals[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t big, small;
      split(vals[e], big, small);
      const uint32_t off = kmajor<64>(4 * c4 + e, tp);
      *reinterpret_cast<uint32_t*>(r1 + off) = big;
      *reinterpret_cast<uint32_t*>(r1 + term + off) = small;
    }
  }
}

// The staged x^T turned into (x o w)^T in place: each 8 tokens of a row
// read back as big + small (x within 2^-22), times w, split again and
// stored in the natural token order.
__device__ __forceinline__ void rescale_xt(uint8_t* r1, const float* w,
                                           int term) {
  for (int i = threadIdx.x; i < 64 * (QP / 8); i += NT) {
    const int pp = i & 63;
    const int g8 = i >> 6;
    const uint32_t off = kmajor<64>(pp, 8 * g8);   // positions 0-3
    const uint32_t off2 = kmajor<64>(pp, 8 * g8 + 4);
    const uint4 b0 = *reinterpret_cast<const uint4*>(r1 + off);
    const uint4 b1 = *reinterpret_cast<const uint4*>(r1 + off2);
    const uint4 s0 = *reinterpret_cast<const uint4*>(r1 + term + off);
    const uint4 s1 = *reinterpret_cast<const uint4*>(r1 + term + off2);
    const uint32_t bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const uint32_t ss[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint32_t ob[8], os[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int pos = (k & 1) * 4 + (k >> 1);   // where token k was staged
      split((__uint_as_float(bb[pos]) + __uint_as_float(ss[pos])) *
                w[8 * g8 + k],
            ob[k], os[k]);
    }
    *reinterpret_cast<uint4*>(r1 + off) = make_uint4(ob[0], ob[1], ob[2],
                                                     ob[3]);
    *reinterpret_cast<uint4*>(r1 + off2) = make_uint4(ob[4], ob[5], ob[6],
                                                      ob[7]);
    *reinterpret_cast<uint4*>(r1 + term + off) =
        make_uint4(os[0], os[1], os[2], os[3]);
    *reinterpret_cast<uint4*>(r1 + term + off2) =
        make_uint4(os[4], os[5], os[6], os[7]);
  }
}

// A 64 x 32 piece of the raw B tile (already in the K-major layout of 64
// rows) split into (big, small) at dst and dst + PIECE.
__device__ __forceinline__ void split_piece(uint8_t* dst, const uint8_t* src,
                                            int piece) {
  for (int i = threadIdx.x; i < piece / 16; i += NT) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    uint4 big, small;
    split(v.x, big.x, small.x);
    split(v.y, big.y, small.y);
    split(v.z, big.z, small.z);
    split(v.w, big.w, small.w);
    reinterpret_cast<uint4*>(dst)[i] = big;
    reinterpret_cast<uint4*>(dst + piece)[i] = small;
  }
}

// d_x += small_a x big_b + big_a x small_b; d_bb += big_a x big_b (one
// m64n64k8 step, B K-major at b_big / b_small).
__device__ __forceinline__ void tf32x3(float (&d_bb)[32], float (&d_x)[32],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       uint32_t b_big, uint32_t b_small) {
  const uint64_t bb = desc_sw128(b_big, 16, 1024);
  wgmma_tf32_rs(d_x, as, bb, 1);
  wgmma_tf32_rs(d_x, ab, desc_sw128(b_small, 16, 1024), 1);
  wgmma_tf32_rs(d_bb, ab, bb, 1);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
}

template <int NKB>
__global__ void __launch_bounds__(NT, 1)
    ssd_tf32(const float* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ B, const float* __restrict__ C,
             const float* __restrict__ s0, float* __restrict__ y, float* sT,
             int* sync, int rows, int nc, int l, int p, int n, int q) {
  using SM = Smem<NKB>;
  constexpr int NP = 64 * NKB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s = smem_u32(sm);
  float* acum = reinterpret_cast<float*>(sm + SM::ACUM);
  float* w = reinterpret_cast<float*>(sm + SM::W);
  const uint8_t* rc = sm + SM::C;
  const uint8_t* rb = sm + SM::B;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int gc = lane & 3;

  const Chunk ch = take_chunk(sync, rows, nc,
                              reinterpret_cast<int*>(sm + SM::TICKET));
  const int npt = (p + PT - 1) / PT;
  const int bh = ch.row / npt;
  const int p0 = (ch.row % npt) * PT;
  const size_t row0 = static_cast<size_t>(bh) * l +
                      static_cast<size_t>(ch.c) * q;
  const float* xg = x + row0 * p + p0;   // raw x goes to R1's small half

  // Raw C and B by cp.async, one group per 32 state columns, and raw x
  // (needed only after C B^T) as the second group: the first piece's
  // products start while the rest lands.
  constexpr int PIECES = NP / 32;
  const float av = load_a(a + row0, q);
#pragma unroll
  for (int pc = 0; pc < PIECES; ++pc) {
    load_tile<float, QP>(s + SM::C + pc * SM::RAW, C + row0 * n + 32 * pc, n,
                         q, n - 32 * pc, 32);
    load_tile<float, QP>(s + SM::B + pc * SM::RAW, B + row0 * n + 32 * pc, n,
                         q, n - 32 * pc, 32);
    cp_async_commit();
    if (pc == 0) {
      fetch_x(s + SM::R1 + SM::TERM, xg, p, q, p - p0);
      cp_async_commit();
    }
  }
  chunk_cumsum(av, acum, reinterpret_cast<float*>(sm + SM::WSUM));
  const float total = acum[QP - 1];
  if (tid < QP) w[tid] = expf(total - acum[tid]);

  // --- (C B^T o L) x, per 64-column block jb of C B^T.
  const int i0 = 64 * wg + 16 * warp + gr;
  float y_bb[32], y_x[32];
  zero(y_bb);
  zero(y_x);
#pragma unroll 1
  for (int jb = 0; jb < 2; ++jb) {
    const bool live = jb <= wg;   // rows 0-63 see no column past 63
    float cb_bb[32], cb_x[32];
    zero(cb_bb);
    zero(cb_x);
    // C B^T over the state columns, 32 at a time: B's piece split into
    // the double-buffered pair, C's fragments split in registers.
#pragma unroll 1
    for (int pc = 0; pc < PIECES; ++pc) {
      if (jb == 0) {   // this piece's columns of raw C and B have landed
        cp_async_wait_pending(pc == 0 ? PIECES : PIECES - 1 - pc);
        __syncthreads();
      }
      uint8_t* piece = sm + SM::R2 + (pc & 1) * 2 * SM::PIECE;
      split_piece(piece, rb + pc * SM::RAW + jb * (64 * 128), SM::PIECE);
      fence_proxy_async();
      __syncthreads();
      if (live) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          frag_a<false>(rc, 64 * wg + 16 * warp, 32 * pc + 8 * kk, gr, gc,
                        ab[kk], as[kk]);
        wgmma_fence();
        const uint32_t pb = smem_u32(piece);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tf32x3(cb_bb, cb_x, ab[kk], as[kk], pb + kk * 32,
                 pb + SM::PIECE + kk * 32);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(cb_bb);
        fence_regs(cb_x);
      }
    }
    if (jb == 0) {   // every group has landed: raw x becomes split x^T
      stage_xt(sm + SM::R1, SM::TERM);
      fence_proxy_async();
      __syncthreads();
    }
    if (live) {
      // L selected in the accumulator, the product split into the TF32 A
      // fragments of the eight 8-column steps: a thread's columns 2c, 2c
      // + 1 go to fragment columns c, c + 4 (x^T is stored in that token
      // order).
      uint32_t mb[8][4], ms[8][4];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = 4 * n8 + e;
          const int i = i0 + 8 * (e >> 1);
          const int j = 64 * jb + 8 * n8 + 2 * gc + (e & 1);
          const float m = i >= j ? (cb_bb[v] + cb_x[v]) *
                                       __expf(acum[i] - acum[j])
                                 : 0.f;
          // e 0 / 1 / 2 / 3 -> fragment registers 0 / 2 / 1 / 3
          const int f = ((e & 1) << 1) | (e >> 1);
          split(m, mb[n8][f], ms[n8][f]);
        }
        fence_regs(mb[n8]);
        fence_regs(ms[n8]);
      }
      wgmma_fence();
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int kg = 8 * jb + n8;
        const uint32_t xa =
            s + SM::R1 + (kg / 4) * (64 * 128) + (kg % 4) * 32;
        tf32x3(y_bb, y_x, mb[n8], ms[n8], xa, xa + SM::TERM);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y_bb);
      fence_regs(y_x);
    }
  }
  float yd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yd[i] = y_bb[i] + y_x[i];
  __syncthreads();   // every read of x^T is done

  // --- the chunk's contribution, transposed: B^T (x o w), (64, 64) per
  // warpgroup: state rows 64 wg .. (warpgroup 1 idles when N <= 64).
  rescale_xt(sm + SM::R1, w, SM::TERM);
  fence_proxy_async();
  __syncthreads();
  float dl[32];
  {
    float d_bb[32], d_x[32];
    zero(d_bb);
    zero(d_x);
    if (wg < NKB) {
#pragma unroll 1
      for (int grp = 0; grp < 4; ++grp) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          frag_a<true>(rb, 64 * wg + 16 * warp, 32 * grp + 8 * kk, gr, gc,
                       ab[kk], as[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t xa = s + SM::R1 + grp * (64 * 128) + kk * 32;
          tf32x3(d_bb, d_x, ab[kk], as[kk], xa, xa + SM::TERM);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d_bb);
        fence_regs(d_x);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dl[i] = d_bb[i] + d_x[i];
  }

  // --- the chain. The contribution's element (state column nn, head-dim
  // row pp) goes to the state's (pp, nn).
  int* flag = sync + 1 + ch.row;
  wait_start_state(flag, ch.c);
  float* slot = sT + (static_cast<size_t>(bh) * p + p0) * n;
  const float* start = ch.c > 0 ? slot
                       : s0 != nullptr
                           ? s0 + (static_cast<size_t>(bh) * p + p0) * n
                           : nullptr;
  const float decay = expf(total);
  float sv[32];   // every load before any store, as in the bfloat16 kernel
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int nn = 64 * wg + 16 * warp + gr + 8 * ((v & 3) >> 1);
    const int pp = 8 * (v >> 2) + 2 * gc + (v & 1);
    const bool ok = wg < NKB && p0 + pp < p && nn < n;
    sv[v] = ok && start != nullptr ? __ldcg(start + pp * n + nn) : 0.f;
  }
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int nn = 64 * wg + 16 * warp + gr + 8 * ((v & 3) >> 1);
    const int pp = 8 * (v >> 2) + 2 * gc + (v & 1);
    if (wg < NKB && p0 + pp < p && nn < n)
      __stcg(slot + pp * n + nn, sv[v] * decay + dl[v]);
  }
  publish(flag, ch.c, nc);

  // --- C S^T, S split into the region x's tiles held.
  if (wg < NKB) {
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int nn = 64 * wg + 16 * warp + gr + 8 * ((v & 3) >> 1);
      const int pp = 8 * (v >> 2) + 2 * gc + (v & 1);
      uint32_t big, small;
      split(sv[v], big, small);
      const uint32_t off = kmajor<64>(pp, nn);
      *reinterpret_cast<uint32_t*>(sm + SM::R1 + off) = big;
      *reinterpret_cast<uint32_t*>(sm + SM::R1 + SM::TERM + off) = small;
    }
  }
  fence_proxy_async();
  __syncthreads();

  float yo_bb[32], yo_x[32];
  zero(yo_bb);
  zero(yo_x);
#pragma unroll 1
  for (int grp = 0; grp < PIECES; ++grp) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      frag_a<false>(rc, 64 * wg + 16 * warp, 32 * grp + 8 * kk, gr, gc,
                    ab[kk], as[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa = s + SM::R1 + grp * (64 * 128) + kk * 32;
      tf32x3(yo_bb, yo_x, ab[kk], as[kk], sa, sa + SM::TERM);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yo_bb);
    fence_regs(yo_x);
  }

  // --- y = (C B^T o L) x + exp(a_cum) o (C S^T).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if (i >= q) continue;
    const float e = expf(acum[i]);
    float* yr = y + (row0 + i) * p + p0;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 8 * nb + 2 * gc;
      const int v = 4 * nb + 2 * h;
      if (p0 + col < p)
        *reinterpret_cast<float2*>(yr + col) =
            make_float2(yd[v] + e * (yo_bb[v] + yo_x[v]),
                        yd[v + 1] + e * (yo_bb[v + 1] + yo_x[v + 1]));
    }
  }
}

}  // namespace tf

template <typename T, int NKB>
cudaError_t launch(int bh, int l, int p, int n, int q, const void* x,
                   const float* a, const void* B, const void* C,
                   const float* s0, void* y, float* sT, int* sync,
                   cudaStream_t stream) {
  const int rows = bh * ((p + PT - 1) / PT);
  const int nc = l / q;
  constexpr bool BF = sizeof(T) == 2;
  const int smem = BF ? bf::Smem<NKB>::BYTES : tf::Smem<NKB>::BYTES;
  auto kernel = BF ? reinterpret_cast<const void*>(&bf::ssd_bf16<NKB>)
                   : reinterpret_cast<const void*>(&tf::ssd_tf32<NKB>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(rows) * static_cast<unsigned>(nc));
  if constexpr (BF)
    bf::ssd_bf16<NKB><<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), a,
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), s0,
        static_cast<__nv_bfloat16*>(y), sT, sync, rows, nc, l, p, n, q);
  else
    tf::ssd_tf32<NKB><<<grid, NT, smem, stream>>>(
        static_cast<const float*>(x), a, static_cast<const float*>(B),
        static_cast<const float*>(C), s0, static_cast<float*>(y), sT, sync,
        rows, nc, l, p, n, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bh, int l, int p, int n, int q, const void* x,
                     const float* a, const void* B, const void* C,
                     const float* s0, void* y, float* sT, int* sync,
                     cudaStream_t stream) {
  return n <= 64 ? launch<T, 1>(bh, l, p, n, q, x, a, B, C, s0, y, sT, sync,
                                stream)
                 : launch<T, 2>(bh, l, p, n, q, x, a, B, C, s0, y, sT, sync,
                                stream);
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. s0 may be null (a zero
// start state). sync holds 1 + BH ceil(P / 64) int32, zero between
// launches (the launch leaves them zero), and is used by one stream at a
// time. Returns a cudaError_t (0 on success); the one launch is
// asynchronous on `stream`.
int ssd_scan_fwd(int dtype, int bh, int l, int p, int n, int q,
                 const void* x, const void* a, const void* B, const void* C,
                 const void* s0, void* y, void* sT, void* sync,
                 void* stream) {
  if (bh <= 0 || q <= 0 || q > QP || l <= 0 || l % q != 0 || p <= 0 ||
      p % 8 != 0 || n <= 0 || n % 8 != 0 || n > NMAX ||
      static_cast<long long>(bh) * ((p + PT - 1) / PT) * (l / q) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  int* sy = static_cast<int*>(sync);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(bh, l, p, n, q, x, af, B, C, s0f, y, sTf,
                                   sy, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(bh, l, p, n, q, x, af, B, C, s0f,
                                             y, sTf, sy, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
