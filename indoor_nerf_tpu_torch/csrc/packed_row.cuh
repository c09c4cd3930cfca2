// What the kernels of the packed block-hash encode share (tent_contract.cu,
// table_scatter.cu, group_scatter.cu): vector access to the VEC adjacent
// features of one vertex in a vertex-major packed row [lpf, F] (element
// lane*F + f), f32 or bf16, widened to and narrowed from f32, and the
// vector reduction into an f32 one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_row {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);  // bfloat16 is the top half of a float32
}

// VEC adjacent features of one vertex, widened to f32, in one load.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(src);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const uint16_t* src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
    v[0] = bf16_bits_to_f32(t.x & 0xffffu), v[1] = bf16_bits_to_f32(t.x >> 16);
    v[2] = bf16_bits_to_f32(t.y & 0xffffu), v[3] = bf16_bits_to_f32(t.y >> 16);
  } else if constexpr (VEC == 2) {
    const uint32_t t = __ldg(reinterpret_cast<const uint32_t*>(src));
    v[0] = bf16_bits_to_f32(t & 0xffffu), v[1] = bf16_bits_to_f32(t >> 16);
  } else {
    v[0] = bf16_bits_to_f32(__ldg(src));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void store_vec(uint16_t* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(f32_to_bf16_bits(v[0]) | (f32_to_bf16_bits(v[1]) << 16),
                   f32_to_bf16_bits(v[2]) | (f32_to_bf16_bits(v[3]) << 16));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint32_t*>(dst) =
        f32_to_bf16_bits(v[0]) | (f32_to_bf16_bits(v[1]) << 16);
  } else {
    dst[0] = static_cast<uint16_t>(f32_to_bf16_bits(v[0]));
  }
}

// One reduction for the VEC adjacent f32 features of a vertex; the result is
// unused, so the compiler emits red, not atom.
template <int VEC>
__device__ __forceinline__ void reduce_vec(float* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

}  // namespace packed_row
