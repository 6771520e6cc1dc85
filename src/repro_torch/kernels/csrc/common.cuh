// Shared helpers of the port's CUDA-core kernels (paged attention, the
// quantized grouped FFN, and the fp32 grouped FFN and flash attention).
//
// These kernels are templates over float and __nv_bfloat16 storage; all
// arithmetic runs in fp32 (FMA), and values are rounded back to the storage
// type with round-to-nearest-even exactly where the JAX reference rounds.
// The bf16 tensor-core kernels use hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16(v);  // round to nearest even
  }
};

// Round an fp32 value through the storage type T (the reference's
// ``.astype(dtype)`` before a product).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Num<T>::to_f(Num<T>::from_f(v));
}

// Load 16 consecutive values of type T from 16-byte aligned shared memory
// into fp32 registers with vector loads.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out);

template <>
__device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = v[i];
    out[4 * i] = q.x;
    out[4 * i + 1] = q.y;
    out[4 * i + 2] = q.z;
    out[4 * i + 3] = q.w;
  }
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 q = v[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// The row stride of the bf16 FFN kernels' h scratch (E, C, stride): F
// rounded up to 8, so every row starts 16-byte aligned
// (kernels/moe_gemm.py::h_scratch_spec allocates it).
__host__ __device__ __forceinline__ int ffn_h_stride(int F) {
  return (F + 7) / 8 * 8;
}
