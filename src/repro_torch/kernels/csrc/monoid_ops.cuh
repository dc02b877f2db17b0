// The elementwise ⊕ of the port's CUDA kernels, shared by
// round_kernels.cu and chunked_scan.cu so that every kernel rounds the
// same way.
//
// Float ⊕ use the _rn intrinsics, so nvcc never contracts a multiply
// and an add into an FMA; bf16 computes in fp32 and rounds once to
// bf16; max/min propagate NaN like torch.maximum/torch.minimum.  That
// is what PyTorch's own elementwise kernels do, so a kernel built on
// these is bit-identical to its plain PyTorch version.
//
// The op and dtype codes are the ones the Python wrappers pass
// (kernels/scan_engine.py, _OP_CODES and _DT_CODES).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_ADD = 0, OP_MUL = 1, OP_MAX = 2, OP_MIN = 3, OP_XOR = 4,
       OP_AFFINE = 5 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_BF16 = 4 };
enum { ERR_UNSUPPORTED = 10001 };

typedef __nv_bfloat16 bf16;

// ---- the elementwise ⊕ at each type --------------------------------------

__device__ __forceinline__ int32_t add_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int64_t add_(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ bf16 add_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ int32_t mul_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int64_t mul_(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ bf16 mul_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// max/min propagate NaN like torch.maximum/torch.minimum
__device__ __forceinline__ int32_t max_(int32_t a, int32_t b) { return a < b ? b : a; }
__device__ __forceinline__ int64_t max_(int64_t a, int64_t b) { return a < b ? b : a; }
__device__ __forceinline__ float max_(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ double max_(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmax(a, b));
}
__device__ __forceinline__ bf16 max_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(max_(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ int32_t min_(int32_t a, int32_t b) { return b < a ? b : a; }
__device__ __forceinline__ int64_t min_(int64_t a, int64_t b) { return b < a ? b : a; }
__device__ __forceinline__ float min_(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ double min_(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmin(a, b));
}
__device__ __forceinline__ bf16 min_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(min_(__bfloat162float(a), __bfloat162float(b)));
}

struct OpAdd { template <class T> __device__ static T f(T a, T b) { return add_(a, b); } };
struct OpMul { template <class T> __device__ static T f(T a, T b) { return mul_(a, b); } };
struct OpMax { template <class T> __device__ static T f(T a, T b) { return max_(a, b); } };
struct OpMin { template <class T> __device__ static T f(T a, T b) { return min_(a, b); } };
struct OpXor { template <class T> __device__ static T f(T a, T b) { return a ^ b; } };

}  // namespace
