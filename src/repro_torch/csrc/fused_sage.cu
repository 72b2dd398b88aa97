// Fused LD aggregate + weight matmul for Hopper (sm_90a), plain C interface.
//
// K3 fused_ld_grouped replaces the Pallas kernel
//    src/repro/kernels/fused_sage.py:_fused_kernel_grouped (launched by
//    fused_ld_matmul_grouped).  For one ELL bucket of degree d:
//        out[r, :] = sum_g ( sum_{k<d} wg[r*d+k, g] * x[cols[r*d+k], :] ) @ W[g]
//    with W the (G, F, H) f32 weight stack of one SAGE layer.
// K7 fused_ld replaces src/repro/kernels/fused_sage.py:_fused_kernel (launched
//    by fused_ld_matmul): the ungrouped form, one (F, H) matrix and an
//    optional per-slot weight whose product with x is rounded to the stream
//    dtype before the sum (the reference pre-weights its messages in x.dtype):
//        out[r, :] = ( sum_{k<d} x[cols[r*d+k], :] (* w[r*d+k]) ) @ W
//    It is K3's code at one group.
//
// Bound on the H100: memory.  Per destination row it reads d rows of x, d*G
// weights and d indices and writes H f32 outputs, for d*G*F + G*F*H
// multiply-adds; at F = H = 32, G = 4 and d <= 2 that is about 2 operations per
// byte, under the ~20 f32 operations per byte at which the 67 TFLOP/s f32 rate
// would bind.  The least bytes are the distinct x rows touched, the staged
// weights, the indices and the (R, H) f32 output, each moved once, at 3.35 TB/s.
//
// What the design does about it:
//  * The gather is fused as in K1: each warp reads its row's neighbours
//    through cols, lanes on consecutive features (coalesced 128-byte rows).
//  * The G aggregated rows never reach device memory: a warp parks its
//    (G, F) aggregate in shared memory and immediately contracts it with the
//    weight stack, which every block loads once into shared memory
//    (G*F*H*4 = 16 KB at the model's width, 4 KB for K7) and reuses across the
//    rows it strides over.  The unfused walk would write and re-read G*F
//    floats per row; here only H floats per row are written.
//  * The contraction is a plain f32 FMA loop (lanes on output columns,
//    conflict-free shared-memory reads).  Tensor cores (wgmma) are a later
//    optimisation: at this arithmetic intensity memory, not FLOPs, binds.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64.
#include "common.cuh"

namespace {

using groot::kWarp;

constexpr int kFusedWarps = 8;      // rows in flight per block (one per warp)
constexpr int kBlocksPerSm = 8;     // grid = SMs * this, rows strided over it

// K3 (kWeighted, !kRound) and K7 (G = 1, kRound).
template <typename T, int G, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kFusedWarps * kWarp)
fused_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
             const T* __restrict__ wg, const float* __restrict__ w_stack,
             float* __restrict__ out, int64_t rows, int deg, int feat, int hid) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int w_elems = G * feat * hid;
  float* w_sm = smem;
  float* agg = smem + w_elems + warp * G * feat;
  for (int i = threadIdx.x; i < w_elems; i += blockDim.x) w_sm[i] = w_stack[i];
  __syncthreads();

  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kFusedWarps + warp; row < rows;
       row += static_cast<int64_t>(gridDim.x) * kFusedWarps) {
    const int64_t base = row * deg;
    for (int f = lane; f < feat; f += kWarp) {
      float acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
      for (int k = 0; k < deg; ++k) {
        const int64_t s = base + k;
        const int64_t c = cols[s];
        const T xv = x[c * feat + f];
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g] = groot::accumulate<kWeighted, kRound>(
              acc[g], xv, groot::slot_weight<kWeighted, G>(wg, s, g));
      }
#pragma unroll
      for (int g = 0; g < G; ++g) agg[g * feat + f] = acc[g];
    }
    __syncwarp();
    for (int h = lane; h < hid; h += kWarp) {
      float o = 0.f;
      for (int gf = 0; gf < G * feat; ++gf) o = fmaf(agg[gf], w_sm[gf * hid + h], o);
      out[row * hid + h] = o;
    }
    __syncwarp();  // the next row overwrites this warp's aggregate
  }
}

template <typename T, int G, bool kWeighted, bool kRound>
int launch(const void* x, const void* cols, const void* wg, const void* w_stack, void* out,
           int64_t rows, int deg, int feat, int hid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * feat * hid +
                                       static_cast<size_t>(kFusedWarps) * G * feat);
  auto kernel = fused_kernel<T, G, kWeighted, kRound>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (rows + kFusedWarps - 1) / kFusedWarps;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const dim3 grid(static_cast<unsigned>(need < cap ? need : cap));
  kernel<<<grid, kFusedWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<const float*>(w_stack), static_cast<float*>(out), rows, deg, feat, hid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int groups, const void* x, const void* cols, const void* wg, const void* w_stack,
             void* out, int64_t rows, int deg, int feat, int hid, cudaStream_t stream) {
  switch (groups) {
    case 1: return launch<T, 1, true, false>(x, cols, wg, w_stack, out, rows, deg, feat, hid, stream);
    case 2: return launch<T, 2, true, false>(x, cols, wg, w_stack, out, rows, deg, feat, hid, stream);
    case 3: return launch<T, 3, true, false>(x, cols, wg, w_stack, out, rows, deg, feat, hid, stream);
    case 4: return launch<T, 4, true, false>(x, cols, wg, w_stack, out, rows, deg, feat, hid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_ungrouped(const void* x, const void* cols, const void* w, const void* w_mat,
                       void* out, int64_t rows, int deg, int feat, int hid, cudaStream_t stream) {
  return w ? launch<T, 1, true, true>(x, cols, w, w_mat, out, rows, deg, feat, hid, stream)
           : launch<T, 1, false, true>(x, cols, w, w_mat, out, rows, deg, feat, hid, stream);
}

}  // namespace

extern "C" int fused_ld_grouped(const void* x, const void* cols, const void* wg,
                                const void* w_stack, void* out, int64_t rows, int deg,
                                int groups, int feat, int hid, int bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(groups, x, cols, wg, w_stack, out, rows, deg, feat, hid, st)
              : dispatch<float>(groups, x, cols, wg, w_stack, out, rows, deg, feat, hid, st);
}

// w may be null (no weights)
extern "C" int fused_ld(const void* x, const void* cols, const void* w, const void* w_mat,
                        void* out, int64_t rows, int deg, int feat, int hid, int bf16,
                        void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_ungrouped<__nv_bfloat16>(x, cols, w, w_mat, out, rows, deg, feat, hid, st)
              : dispatch_ungrouped<float>(x, cols, w, w_mat, out, rows, deg, feat, hid, st);
}
