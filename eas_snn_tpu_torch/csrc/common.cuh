// Shared pieces of the port's kernels: the f32 PLIF membrane step and
// input conversion. Every float operation of the membrane update is
// written with an explicit rounding intrinsic so that nvcc cannot contract
// it into an FMA: the kernels then agree bit for bit with the plain
// PyTorch versions, which round after every operation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

// One PLIF step in f32: v = v*a + x; s = [v - th >= 0] (ge) or [> 0];
// v -= th*s. Returns the spike.
__device__ __forceinline__ int8_t plif_step(float& v, float x, float a,
                                            float th, int ge) {
  v = __fadd_rn(__fmul_rn(v, a), x);
  const float d = __fsub_rn(v, th);
  const bool s = ge ? (d >= 0.f) : (d > 0.f);
  v = __fsub_rn(v, __fmul_rn(th, s ? 1.f : 0.f));
  return s ? 1 : 0;
}

// Storage value -> f32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The BN output (x - mean) * mul + bias in f32, rounded to the storage
// dtype (the last argument selects it), returned as f32.
__device__ __forceinline__ float bn_apply(float x, float mean, float mul,
                                          float bias, float) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}
__device__ __forceinline__ float bn_apply(float x, float mean, float mul,
                                          float bias, __nv_bfloat16) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
  return __bfloat162float(__float2bfloat16_rn(y));
}

// Storage value -> the bf16 operand of the conv's multiply (int8 spike
// counts are exact in bf16). bf16 x bf16 products are exact in f32.
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16_rn(static_cast<float>(x));
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<1> { using type = uint8_t; };

// N adjacent elements of V held in registers as raw chunks of up to 16
// bytes, so that they move with one load or store a chunk (the address
// must be aligned to the chunk); get / set unpack and pack them.
template <typename V, int N>
struct Vals {
  static constexpr int kBytes = (int)sizeof(V) * N;
  static constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  static constexpr int kCount = kBytes / kChunk;
  using R = typename Raw<kChunk>::type;
  R raw[kCount];

  __device__ __forceinline__ void load(const V* p) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) raw[i] = reinterpret_cast<const R*>(p)[i];
  }
  __device__ __forceinline__ void store(V* p) const {
#pragma unroll
    for (int i = 0; i < kCount; ++i) reinterpret_cast<R*>(p)[i] = raw[i];
  }
  __device__ __forceinline__ void get(V (&v)[N]) const {
    memcpy(v, raw, sizeof(raw));
  }
  __device__ __forceinline__ void set(const V (&v)[N]) {
    memcpy(raw, v, sizeof(raw));
  }
};
