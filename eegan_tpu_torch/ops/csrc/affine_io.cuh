// Float32 conversion and packed vector access for the affine kernels
// (affine_mask_relu.cu, affine_mask_relu_bwd.cu): float32 or bfloat16
// storage, float32 arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace eegan_affine {

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // Round to nearest even, as torch's float -> bfloat16 cast.
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Plain storage types of 2-16 bytes for the vector accesses.
template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using T = unsigned short;
};
template <>
struct Raw<4> {
  using T = unsigned int;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<16> {
  using T = uint4;
};

// V elements of T, kept packed as loaded (16-byte accesses where V allows).
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = (int)sizeof(T) * V;
  static constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using R = typename Raw<kChunk>::T;
  R raw[kBytes / kChunk];

  // p when ok, else zeros; base (any valid address) keeps the address in
  // bounds should the load be issued all the same.
  __device__ __forceinline__ void load_if(bool ok, const T* p,
                                          const T* base) {
    const R* q = reinterpret_cast<const R*>(ok ? p : base);
#pragma unroll
    for (int k = 0; k < kBytes / kChunk; ++k) {
      raw[k] = __ldg(q + k);
      if (!ok) raw[k] = R{};
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return Io<T>::to_f(reinterpret_cast<const T*>(raw)[e]);
  }
};

// Stores V floats at p as T, in 16-byte accesses where V allows.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* in) {
  constexpr int kBytes = (int)sizeof(T) * V;
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using R = typename Raw<kChunk>::T;
  R raw[kBytes / kChunk];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = Io<T>::from_f(in[k]);
#pragma unroll
  for (int k = 0; k < kBytes / kChunk; ++k)
    reinterpret_cast<R*>(p)[k] = raw[k];
}

}  // namespace eegan_affine
