// Pieces the attention kernels (flash_attention.cu, flash_decode.cu)
// share: the masked-score value and the 16-byte row loads / output stores
// for float32 and bfloat16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A masked score, as in the Pallas kernels: finite, so exp(NEG_INF - m)
// is 0 and a fully masked row never makes NaN.
constexpr float NEG_INF = -2.0e38f;

// Sixteen bytes at p (4 floats or 8 bfloat16s) widened to float32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One float32 result stored in the output's type (round to nearest).
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
