// Grouped degree-bucketed SpMM walks for Hopper (sm_90a), plain C interface.
//
// K1 groot_ld_grouped replaces the Pallas kernel
//    src/repro/kernels/groot_spmm.py:_ld_kernel_grouped (launched by
//    ld_grouped_apply).  For one ELL bucket of degree d:
//        out[g, r, :] = sum_{k<d} wg[r*d+k, g] * x[cols[r*d+k], :]
// K2 groot_hd_grouped replaces src/repro/kernels/groot_spmm.py:_hd_kernel_grouped
//    (launched by hd_grouped_apply): the same sum over a high-degree row whose
//    edges come as consecutive e_t-edge chunks.
//
// Bound on the H100: memory.  Each edge slot costs one F-wide row read of x
// plus G weights and one index, for G*F multiply-adds: about 0.5-1 operation
// per byte, far under the ~20 f32 operations per byte at which the card's
// 67 TFLOP/s f32 rate would bind.  The least bytes are the distinct x rows the
// bucket touches, the staged weights, the column indices and the (G, R, F)
// f32 output, each moved once, at 3.35 TB/s.
//
// What the design does about it:
//  * The gather is fused.  On the TPU, x[cols] is an XLA gather that writes
//    an (R*d, F) message slab to HBM before the kernel reads it back.  Here the
//    kernel reads each source row through cols directly, so the slab never
//    exists.  One warp owns one destination row and its lanes own 32
//    consecutive features: with F = 32 in f32 every neighbour read is one
//    coalesced 128-byte transaction (64 bytes for bf16 streams).
//  * One message load serves all G groups; the G weights of an edge slot are
//    warp-uniform loads (one transaction, broadcast).
//  * No lane padding: F is kept whole (the TPU pads it to 128 lanes, which
//    would quadruple every gathered byte at hidden = 32).
//  * Each bucket writes its rows straight into its slice of the (G, asm_rows,
//    F) concatenation buffer that the permutation assembly reads.
//  * K2: a CUDA grid runs in no order, so the TPU kernel's trick of keeping a
//    row's output resident across consecutive grid steps does not carry over.
//    One block owns one HD row and loops over all of its chunks; its warps
//    stride over the row's edges and reduce through shared memory in a fixed
//    order.  No atomics, so the result is deterministic.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64
// (G * rows * F passes 2^31 for batches of the largest designs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLdWarps = 8;  // destination rows per LD block (one per warp)
constexpr int kHdWarps = 8;  // warps sharing one HD row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int G>
__global__ void __launch_bounds__(kLdWarps * kWarp)
ld_grouped_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                  const T* __restrict__ wg, float* __restrict__ out,
                  int64_t rows, int deg, int feat, int64_t out_gstride) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLdWarps + (threadIdx.x / kWarp);
  if (row >= rows) return;
  const int64_t base = row * deg;
  for (int f0 = 0; f0 < feat; f0 += kWarp) {
    const int f = f0 + lane;
    const bool live = f < feat;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int k = 0; k < deg; ++k) {
      const int64_t s = base + k;
      const int64_t c = cols[s];
      const float xv = live ? to_f32(x[c * feat + f]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(to_f32(wg[s * G + g]), xv, acc[g]);
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * out_gstride + row * feat + f] = acc[g];
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kHdWarps * kWarp)
hd_grouped_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                  const T* __restrict__ wg, const int32_t* __restrict__ row_chunks,
                  float* __restrict__ out, int e_t, int feat, int64_t out_gstride) {
  __shared__ float red[kHdWarps][G][kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t row = blockIdx.x;
  const int64_t s0 = static_cast<int64_t>(row_chunks[2 * row]) * e_t;
  const int64_t s1 = s0 + static_cast<int64_t>(row_chunks[2 * row + 1]) * e_t;
  for (int f0 = 0; f0 < feat; f0 += kWarp) {
    const int f = f0 + lane;
    const bool live = f < feat;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int64_t s = s0 + warp; s < s1; s += kHdWarps) {
      const int64_t c = cols[s];
      const float xv = live ? to_f32(x[c * feat + f]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(to_f32(wg[s * G + g]), xv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) red[warp][g][lane] = acc[g];
    __syncthreads();
    if (warp == 0 && live) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kHdWarps; ++w) t += red[w][g][lane];
        out[g * out_gstride + row * feat + f] = t;
      }
    }
    __syncthreads();
  }
}

template <typename T, int G>
void launch_ld(const void* x, const void* cols, const void* wg, void* out, int64_t rows,
               int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kLdWarps - 1) / kLdWarps));
  ld_grouped_kernel<T, G><<<grid, kLdWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<float*>(out), rows, deg, feat, out_gstride);
}

template <typename T, int G>
void launch_hd(const void* x, const void* cols, const void* wg, const void* row_chunks,
               void* out, int64_t n_hd, int e_t, int feat, int64_t out_gstride,
               cudaStream_t stream) {
  hd_grouped_kernel<T, G><<<static_cast<unsigned>(n_hd), kHdWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<const int32_t*>(row_chunks), static_cast<float*>(out), e_t, feat,
      out_gstride);
}

template <typename T>
int dispatch_ld(int groups, const void* x, const void* cols, const void* wg, void* out,
                int64_t rows, int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: launch_ld<T, 1>(x, cols, wg, out, rows, deg, feat, out_gstride, stream); break;
    case 2: launch_ld<T, 2>(x, cols, wg, out, rows, deg, feat, out_gstride, stream); break;
    case 3: launch_ld<T, 3>(x, cols, wg, out, rows, deg, feat, out_gstride, stream); break;
    case 4: launch_ld<T, 4>(x, cols, wg, out, rows, deg, feat, out_gstride, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int groups, const void* x, const void* cols, const void* wg,
                const void* row_chunks, void* out, int64_t n_hd, int e_t, int feat,
                int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: launch_hd<T, 1>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream); break;
    case 2: launch_hd<T, 2>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream); break;
    case 3: launch_hd<T, 3>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream); break;
    case 4: launch_hd<T, 4>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int groot_ld_grouped(const void* x, const void* cols, const void* wg, void* out,
                                int64_t rows, int deg, int groups, int feat,
                                int64_t out_gstride, int bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_ld<__nv_bfloat16>(groups, x, cols, wg, out, rows, deg, feat, out_gstride, st)
              : dispatch_ld<float>(groups, x, cols, wg, out, rows, deg, feat, out_gstride, st);
}

extern "C" int groot_hd_grouped(const void* x, const void* cols, const void* wg,
                                const void* row_chunks, void* out, int64_t n_hd, int e_t,
                                int groups, int feat, int64_t out_gstride, int bf16,
                                void* stream) {
  if (n_hd <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_hd<__nv_bfloat16>(groups, x, cols, wg, row_chunks, out, n_hd, e_t, feat,
                                           out_gstride, st)
              : dispatch_hd<float>(groups, x, cols, wg, row_chunks, out, n_hd, e_t, feat,
                                   out_gstride, st);
}
