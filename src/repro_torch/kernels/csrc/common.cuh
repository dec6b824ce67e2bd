// Shared helpers of the SpMV kernels: value types, accumulation types and
// the arithmetic the Pallas kernels did in their accumulation dtype.
//
// * bf16 / f16 / f32 values accumulate in f32, i8 / i16 / i32 in i32
//   (repro/kernels/ref.py:_acc_dtype).
// * Float products and sums use __fmul_rn / __fadd_rn so that nvcc never
//   contracts them into an FMA: each product is rounded once, as in the
//   plain versions.
// * Integer products and sums wrap like JAX's int32 (two's complement),
//   computed on unsigned ints to stay clear of signed-overflow UB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py:DTYPE_CODES)
enum DType : int { F32 = 0, BF16 = 1, F16 = 2, I8 = 3, I16 = 4, I32 = 5 };

template <typename V> struct Acc { using type = int32_t; };
template <> struct Acc<float> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ int32_t to_acc(int8_t v) { return v; }
__device__ __forceinline__ int32_t to_acc(int16_t v) { return v; }
__device__ __forceinline__ int32_t to_acc(int32_t v) { return v; }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

}  // namespace repro

// Expands to a switch over the value dtype, binding V in the body.
#define REPRO_DISPATCH_DTYPE(code, ...)                       \
  switch (code) {                                             \
    case repro::F32: { using V = float; __VA_ARGS__; break; }           \
    case repro::BF16: { using V = __nv_bfloat16; __VA_ARGS__; break; }  \
    case repro::F16: { using V = __half; __VA_ARGS__; break; }          \
    case repro::I8: { using V = int8_t; __VA_ARGS__; break; }           \
    case repro::I16: { using V = int16_t; __VA_ARGS__; break; }         \
    case repro::I32: { using V = int32_t; __VA_ARGS__; break; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }
