// Device helpers shared by the port's kernels (groot_spmm.cu, fused_sage.cu).
//
// Two ways an edge slot enters a row sum, matching the two kinds of Pallas
// kernel they replace:
//  * grouped (K1-K3): the staged group weight and the message are widened to
//    f32 and fused into the accumulator, fmaf(w, x, acc), as the grouped
//    Pallas kernels widen before they multiply;
//  * ungrouped (K5-K7) and the grouped MXU kernel (K4): the product x * w is
//    taken in the stream dtype (rounded to bf16 for bf16 streams, a separately
//    rounded f32 multiply for f32 streams) and only then summed in f32, as the
//    reference multiplies the gathered messages by the weights in x.dtype
//    before its kernel runs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace groot {

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x * w rounded once to the stream dtype (no contraction into an FMA).
__device__ __forceinline__ float mul_round(float x, float w) { return __fmul_rn(x, w); }
__device__ __forceinline__ __nv_bfloat16 mul_round(__nv_bfloat16 x, __nv_bfloat16 w) {
  // the f32 product of two bf16 values is exact; one rounding to bf16 follows
  return __float2bfloat16_rn(__bfloat162float(x) * __bfloat162float(w));
}

// One edge slot's contribution to one group's accumulator.  ``w`` is the
// slot's staged weight for that group; unused when kWeighted is false.
template <bool kWeighted, bool kRound, typename T>
__device__ __forceinline__ float accumulate(float acc, T xv, T w) {
  if constexpr (!kWeighted) {
    return acc + to_f32(xv);
  } else if constexpr (kRound) {
    return acc + to_f32(mul_round(xv, w));
  } else {
    return fmaf(to_f32(w), to_f32(xv), acc);
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// Weight of one slot for group g, or a dummy when the stream has no weights.
template <bool kWeighted, int G, typename T>
__device__ __forceinline__ T slot_weight(const T* __restrict__ w, int64_t s, int g) {
  if constexpr (kWeighted) {
    return w[s * G + g];
  } else {
    return zero<T>();
  }
}

}  // namespace groot
