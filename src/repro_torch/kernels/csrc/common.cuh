// Pieces the attention kernels (flash_attention.cu, flash_decode.cu)
// share: the masked-score value, the 16-byte row loads / output stores
// for float32 and bfloat16, and the exponentials of the bfloat16
// attention and decode kernels.

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

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// cap * tanh(y) from one ex2: tanh|y| = (1 - e) / (1 + e), e = exp(-2|y|).
// Its absolute error, about 1e-7 of cap, moves a score by about 5e-6 at a
// cap of 50: a relative 5e-6 in p, far inside the kernels' gates
// (float32 atol 1e-4; bfloat16 atol 1e-5 + rtol 1e-2).
__device__ __forceinline__ float cap_tanh(float y, float cap) {
  const float e = ex2(-2.f * LOG2E * fabsf(y));
  return copysignf(cap * __fdividef(1.f - e, 1.f + e), y);
}
