// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_bh
// (body _ssd_kernel). Per chunk of Q <= 128 tokens of one (batch, head)
// row, with a_cum = cumsum(a) over the chunk:
//   L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0 (selected: the
//             upper triangle's exponent may overflow to inf, and a 0/1
//             mask multiplied in would turn inf into NaN);
//   y       = (C B^T o L) x + exp(a_cum) o (C S^T);
//   S'      = S exp(a_cum[-1]) + (x o exp(a_cum[-1] - a_cum))^T B,
// with the (P, N) state S carried from chunk to chunk, starting at s0.
// Everything is computed in float32 (bfloat16 inputs are widened in shared
// memory), as the Pallas body asks (preferred_element_type=float32).
//
// Layout: x (BH, L, P), a (BH, L) float32, B / C (BH, L, N), s0 (BH, P, N)
// float32 or none; y (BH, L, P) in x's type, sT (BH, P, N) float32. x, B
// and C share the type (float32 or bfloat16); L is a multiple of Q; P and
// N are multiples of 8, N <= 128.
//
// What bounds it: at mamba2-130m's widths (P 64, N 128, Q 128) a chunk is
// 2Q(QN + QP + 2NP) = 10.5 MFLOP against about 100 KB of float32 inputs,
// so the float32 work on the CUDA cores (67 TFLOP/s) bounds it; with
// bfloat16 inputs, measured against the tensor-core rate, the bytes do.
// This first version keeps every product on the CUDA cores in float32.
//
// Design. The TPU kernel walks the chunks of one row in order, carrying S
// in VMEM; that is BH blocks, 24 at batch 1, a fifth of the card's 132
// SMs. Here the work is split in the GPU form of SSD, three launches:
//   1. ssd_chunk_state (grid chunks x BH): each chunk's own state
//      contribution (x o w)^T B and its total decay a_cum[-1];
//   2. ssd_state_pass (one thread per state element of a row): the short
//      sequential pass over the chunks, S_c+1 = S_c exp(total_c) + the
//      chunk's contribution, writing the state each chunk starts from over
//      the contribution, and the final state sT;
//   3. ssd_chunk_scan (grid chunks x BH): y of each chunk from its start
//      state.
// Tiles: one chunk's x, B, C and S in float32 and the (Q, Q) C B^T o L
// tile would take 256 KB, above the 227 KB a block may use; the scan
// keeps C and B (transposed, k-major) for C B^T, reuses B's space for
// (C B^T o L)^T, and walks P in tiles of 64 for x and S: 205 KB, one
// 256-thread block per SM. The chunk-state kernel needs 101 KB, two
// blocks per SM. Every product is a small shared-memory GEMM: a 16 x 16
// thread grid, each thread an 8 x 8 (or 8 x 4, 4 x 8) register tile whose
// rows and columns sit in two runs of four, read as float4.

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per block, a 16 x 16 grid
constexpr int QMAX = 128;         // chunk length the tiles hold
constexpr int NMAX = 128;         // state size the tiles hold
constexpr int PT = 64;            // head-dim tile
constexpr int LDQ = QMAX + 4;     // row strides of the shared tiles (floats;
constexpr int LDN = NMAX + 4;     // multiples of 4 keep float4 reads
constexpr int LDP = PT + 4;       // aligned)

// Row or column `m` of a thread's register tile: two runs of four, 64
// apart (4 x 16 threads cover 64 rows per run).
__device__ __forceinline__ int tile_index(int t, int m) {
  return 4 * t + 64 * (m / 4) + (m % 4);
}

// Inclusive prefix sum of a[0, q) (0 past q) into acum[0, QMAX), by the
// first QMAX threads; wsum holds QMAX / 32 warp totals.
__device__ __forceinline__ void chunk_cumsum(const float* a, int q,
                                             float* acum, float* wsum) {
  const int t = threadIdx.x;
  float v = 0.f;
  if (t < QMAX) {
    v = t < q ? a[t] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if ((t & 31) >= o) v += u;
    }
    if ((t & 31) == 31) wsum[t >> 5] = v;
  }
  __syncthreads();
  if (t < QMAX) {
    for (int w = 0; w < (t >> 5); ++w) v += wsum[w];
    acum[t] = v;
  }
  __syncthreads();
}

// Copy a ROWS x COLS tile of a row-major matrix g (row stride ld_g) into
// shared memory as float32, natural (sm[r * LD + c]) or transposed
// (sm[c * LD + r]), each row times row_scale[r] when given; elements at
// rows >= n_rows or columns >= n_cols are 0. n_cols is a multiple of 8, so
// a 16-byte vector is either all inside or all outside.
template <typename T, int ROWS, int COLS, int LD, bool TRANS>
__device__ __forceinline__ void stage(float* sm, const T* g, size_t ld_g,
                                      int n_rows, int n_cols,
                                      const float* row_scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = COLS / V;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * V;
    float vals[V];
    if (r < n_rows && c < n_cols) {
      load16(g + r * ld_g + c, vals);
      if (row_scale != nullptr) {
#pragma unroll
        for (int e = 0; e < V; ++e) vals[e] *= row_scale[r];
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (TRANS)
        sm[(c + e) * LD + r] = vals[e];
      else
        sm[r * LD + c + e] = vals[e];
    }
  }
}

// acc[m][n] += sum_{k < K} A[k][row m] * B[k][col n]: A and B k-major in
// shared memory (strides lda, ldb); the thread's rows are
// tile_index(ty, m), its columns tile_index(tx, n).
template <int TM, int TN>
__device__ __forceinline__ void gemm_k(float (&acc)[TM][TN], const float* A,
                                       int lda, const float* B, int ldb,
                                       int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(A + k * lda + 64 * h + 4 * ty);
      av[4 * h] = v.x; av[4 * h + 1] = v.y;
      av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(B + k * ldb + 64 * h + 4 * tx);
      bv[4 * h] = v.x; bv[4 * h + 1] = v.y;
      bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

constexpr size_t STATE_SMEM =
    sizeof(float) * (QMAX * LDP + QMAX * LDN + 2 * QMAX + QMAX / 32);
constexpr size_t SCAN_SMEM =
    sizeof(float) * (2 * NMAX * LDQ + QMAX * LDP + NMAX * LDP + QMAX +
                     QMAX / 32);
static_assert(NMAX == QMAX, "the scan reuses B's tile for the Q x Q tile");

// 1. Each chunk's state contribution (x o w)^T B, (P, N), with w =
// exp(a_cum[-1] - a_cum), into states[bh][c]; its a_cum[-1] into
// decay[bh][c].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ a,
                    const T* __restrict__ B, float* __restrict__ states,
                    float* __restrict__ decay, int l, int p, int n, int q) {
  extern __shared__ float4 smem4[];
  float* xw = reinterpret_cast<float*>(smem4);   // [QMAX][LDP]
  float* bs = xw + QMAX * LDP;                    // [QMAX][LDN]
  float* acum = bs + QMAX * LDN;                  // [QMAX]
  float* w = acum + QMAX;                         // [QMAX]
  float* wsum = w + QMAX;                         // [QMAX / 32]
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = static_cast<size_t>(bh) * l + static_cast<size_t>(c) * q;

  chunk_cumsum(a + row0, q, acum, wsum);
  const float total = acum[q - 1];
  if (threadIdx.x < QMAX) w[threadIdx.x] = expf(total - acum[threadIdx.x]);
  stage<T, QMAX, NMAX, LDN, false>(bs, B + row0 * n, n, q, n, nullptr);
  float* out = states + (static_cast<size_t>(bh) * nc + c) * p * n;
  for (int p0 = 0; p0 < p; p0 += PT) {
    __syncthreads();   // w and bs written; xw free from the last tile
    stage<T, QMAX, PT, LDP, false>(xw, x + row0 * p + p0, p, q, p - p0, w);
    __syncthreads();
    float acc[4][8] = {};
    gemm_k<4, 8>(acc, xw, LDP, bs, LDN, q, ty, tx);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pp = p0 + tile_index(ty, m);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = tile_index(tx, j);
        if (pp < p && nn < n) out[static_cast<size_t>(pp) * n + nn] = acc[m][j];
      }
    }
  }
  if (threadIdx.x == 0) decay[static_cast<size_t>(bh) * nc + c] = total;
}

// 2. The state each chunk starts from, over its contribution in states,
// and the final state. One thread per (row, state element); the
// contributions of PASS_AHEAD chunks are loaded before they are used, so
// a thread keeps that many loads in flight instead of one.
constexpr int PASS_AHEAD = 8;

__global__ void __launch_bounds__(NT)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
                   const float* __restrict__ s0, float* __restrict__ sT,
                   int bh, int nc, int pn) {
  const size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (e >= static_cast<size_t>(bh) * pn) return;
  const size_t row = e / pn, r = e % pn;
  float* st = states + row * nc * pn + r;
  const float* dc = decay + row * nc;
  float s = s0 != nullptr ? s0[e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += PASS_AHEAD) {
    float contrib[PASS_AHEAD], dec[PASS_AHEAD];
#pragma unroll
    for (int u = 0; u < PASS_AHEAD; ++u) {
      if (c0 + u < nc) {
        contrib[u] = st[static_cast<size_t>(c0 + u) * pn];
        dec[u] = expf(dc[c0 + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_AHEAD; ++u) {
      if (c0 + u < nc) {
        st[static_cast<size_t>(c0 + u) * pn] = s;
        s = s * dec[u] + contrib[u];
      }
    }
  }
  sT[e] = s;
}

// 3. y of each chunk: (C B^T o L) x + exp(a_cum) o (C S^T), S the state
// the chunk starts from (states[bh][c] after the pass).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
    ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ a,
                   const T* __restrict__ B, const T* __restrict__ C,
                   const float* __restrict__ states, T* __restrict__ y, int l,
                   int p, int n, int q) {
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);   // [NMAX][LDQ]: C^T
  float* bt = ct + NMAX * LDQ;                    // [NMAX][LDQ]: B^T, then
                                                  // (C B^T o L)^T
  float* xs = bt + NMAX * LDQ;                    // [QMAX][LDP]: x tile
  float* st = xs + QMAX * LDP;                    // [NMAX][LDP]: S^T tile
  float* acum = st + NMAX * LDP;                  // [QMAX]
  float* wsum = acum + QMAX;                      // [QMAX / 32]
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = static_cast<size_t>(bh) * l + static_cast<size_t>(c) * q;

  chunk_cumsum(a + row0, q, acum, wsum);
  stage<T, QMAX, NMAX, LDQ, true>(ct, C + row0 * n, n, q, n, nullptr);
  stage<T, QMAX, NMAX, LDQ, true>(bt, B + row0 * n, n, q, n, nullptr);
  __syncthreads();

  // C B^T (i rows, j columns), then o L, stored transposed over B^T.
  float cb[8][8] = {};
  gemm_k<8, 8>(cb, ct, LDQ, bt, LDQ, n, ty, tx);
  __syncthreads();   // every thread is done reading B^T
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int jj = tile_index(tx, j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = tile_index(ty, 4 * h + r);
        v[r] = (i >= jj && i < q) ? cb[4 * h + r][j] * expf(acum[i] - acum[jj])
                                  : 0.f;
      }
      *reinterpret_cast<float4*>(bt + jj * LDQ + 64 * h + 4 * ty) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  const float* s_chunk = states + (static_cast<size_t>(bh) * nc + c) * p * n;
  for (int p0 = 0; p0 < p; p0 += PT) {
    __syncthreads();   // the L tile written; xs, st free from the last tile
    stage<T, QMAX, PT, LDP, false>(xs, x + row0 * p + p0, p, q, p - p0,
                                   nullptr);
    stage<float, PT, NMAX, LDP, true>(st, s_chunk + static_cast<size_t>(p0) * n,
                                      n, p - p0, n, nullptr);
    __syncthreads();
    float yd[8][4] = {}, yo[8][4] = {};
    gemm_k<8, 4>(yd, bt, LDQ, xs, LDP, q, ty, tx);
    gemm_k<8, 4>(yo, ct, LDQ, st, LDP, n, ty, tx);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = tile_index(ty, m);
      if (i >= q) continue;
      const float dec = expf(acum[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = p0 + 4 * tx + j;
        if (pp < p)
          store_out(y + (row0 + i) * p + pp, yd[m][j] + dec * yo[m][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(int bh, int l, int p, int n, int q, const void* x,
                   const float* a, const void* B, const void* C,
                   const float* s0, void* y, float* sT, float* states,
                   float* decay, cudaStream_t stream) {
  const int nc = l / q;
  const dim3 grid(nc, bh);
  auto k1 = ssd_chunk_state<T>;
  auto k3 = ssd_chunk_scan<T>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(STATE_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SCAN_SMEM));
  if (err != cudaSuccess) return err;
  k1<<<grid, NT, STATE_SMEM, stream>>>(static_cast<const T*>(x), a,
                                       static_cast<const T*>(B), states, decay,
                                       l, p, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = static_cast<size_t>(bh) * p * n;
  ssd_state_pass<<<static_cast<unsigned>((elems + NT - 1) / NT), NT, 0,
                   stream>>>(states, decay, s0, sT, bh, nc, p * n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<grid, NT, SCAN_SMEM, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(B),
      static_cast<const T*>(C), states, static_cast<T*>(y), l, p, n, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. s0 may be null (a zero
// start state). states (BH, L / q, P, N) and decay (BH, L / q) are float32
// scratch. Returns a cudaError_t (0 on success); the three launches are
// asynchronous on `stream`.
int ssd_scan_fwd(int dtype, int bh, int l, int p, int n, int q,
                 const void* x, const void* a, const void* B, const void* C,
                 const void* s0, void* y, void* sT, void* states, void* decay,
                 void* stream) {
  if (bh <= 0 || bh > 65535 || q <= 0 || q > QMAX || l <= 0 || l % q != 0 ||
      p <= 0 || p % 8 != 0 || n <= 0 || n % 8 != 0 || n > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decay);
  cudaError_t err =
      dtype == 0 ? launch<float>(bh, l, p, n, q, x, af, B, C, s0f, y, sTf,
                                 st, dc, s)
      : dtype == 1
          ? launch<__nv_bfloat16>(bh, l, p, n, q, x, af, B, C, s0f, y, sTf,
                                  st, dc, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
