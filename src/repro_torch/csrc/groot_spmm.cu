// Degree-bucketed SpMM walks for Hopper (sm_90a), plain C interface.
//
// Grouped walks (G slot x polarity groups, staged weights wg of G columns):
// K1 groot_ld_grouped replaces the Pallas kernel
//    src/repro/kernels/groot_spmm.py:_ld_kernel_grouped (launched by
//    ld_grouped_apply).  For one ELL bucket of degree d:
//        out[g, r, :] = sum_{k<d} wg[r*d+k, g] * x[cols[r*d+k], :]
// K2 groot_hd_grouped replaces src/repro/kernels/groot_spmm.py:_hd_kernel_grouped
//    (launched by hd_grouped_apply): the same sum over a high-degree row whose
//    edges come as consecutive e_t-edge chunks.
// K4 groot_ld_grouped_mxu replaces src/repro/kernels/groot_spmm.py:
//    _ld_kernel_grouped_mxu (ld_grouped_apply(mxu=True) for d > 1): the K1 sum
//    as G one-hot block-diagonal (16, 16*d) @ (x[cols] * wg[:, g]) products on
//    the tensor cores, each product x * w rounded to the stream dtype first.
//
// Ungrouped walks (an optional per-slot weight w; the product x * w is taken
// in the stream dtype, as the reference pre-weights its messages):
// K5 groot_ld_bucket / groot_ld_bucket_mxu replace
//    src/repro/kernels/groot_spmm.py:_ld_kernel and :_ld_kernel_mxu (launched
//    by ld_bucket_apply):  out[r, :] = sum_{k<d} x[cols[r*d+k], :] (* w[r*d+k]).
//    The VPU body is K1's code at one group; the MXU body is K4's.
// K6 groot_hd replaces src/repro/kernels/groot_spmm.py:_hd_kernel (launched by
//    hd_apply): K5's sum over an HD row's chunks; K2's code at one group.
//
// Bound on the H100: memory.  Each edge slot costs one F-wide row read of x
// plus G weights and one index, for G*F multiply-adds: about 0.5-1 operation
// per byte, far under the ~20 f32 operations per byte at which the card's
// 67 TFLOP/s f32 rate would bind.  The least bytes are the distinct x rows the
// bucket touches, the staged weights, the column indices and the f32 output,
// each moved once, at 3.35 TB/s.  K4's one-hot products do 16x more tensor
// core work than the sums need (a (16, 16*d) operand of which 1/16 is ones),
// still far under the tensor cores' rate (495 TFLOP/s TF32, 989 bf16).
//
// What the design does about it:
//  * The gather is fused.  On the TPU, x[cols] is an XLA gather that writes
//    an (R*d, F) message slab to HBM before the kernel reads it back.  Here the
//    kernel reads each source row through cols directly, so the slab never
//    exists.  K1/K5: one warp owns one destination row and its lanes own 32
//    consecutive features: with F = 32 in f32 every neighbour read is one
//    coalesced 128-byte transaction (64 bytes for bf16 streams).
//  * One message load serves all G groups; the G weights of an edge slot are
//    warp-uniform loads (one transaction, broadcast).
//  * No lane padding: F is kept whole (the TPU pads it to 128 lanes, which
//    would quadruple every gathered byte at hidden = 32).
//  * Each bucket writes its rows straight into its slice of the concatenation
//    buffer that the permutation assembly reads.
//  * K2/K6: a CUDA grid runs in no order, so the TPU kernel's trick of keeping
//    a row's output resident across consecutive grid steps does not carry
//    over.  One block owns one HD row and loops over all of its chunks; its
//    warps stride over the row's edges and reduce through shared memory in a
//    fixed order.  No atomics, so the result is deterministic.
//  * K4: one warp owns a 16-row tile and issues mma.sync per 8-feature column
//    tile and per k-step of the tile's 16*d slots; the one-hot operand A is
//    made in registers from the slot index (no memory), the weighted messages
//    B are loaded straight into the fragment registers (no shared memory).
//    bf16 streams: one m16n8k16 bf16 MMA per step.  f32 streams: the tensor
//    cores take TF32 (11 significant bits), so each product is split into a
//    TF32 high part and a TF32 residual and both go through an m16n8k8 MMA;
//    the one-hot A is exact in TF32.  What the split loses is below 2^-22 of
//    each product.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64
// (G * rows * F passes 2^31 for batches of the largest designs).
#include "common.cuh"

namespace {

using groot::kWarp;

constexpr int kLdWarps = 8;   // destination rows per LD block (one per warp)
constexpr int kHdWarps = 8;   // warps sharing one HD row
constexpr int kMmaWarps = 4;  // 16-row tiles per K4 block (one per warp)
constexpr int kTileRows = 16;

// K1 (kWeighted, !kRound) and K5's VPU body (G = 1, kRound).
template <typename T, int G, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kLdWarps * kWarp)
ld_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
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
      const T xv = live ? x[c * feat + f] : groot::zero<T>();
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = groot::accumulate<kWeighted, kRound>(
            acc[g], xv, groot::slot_weight<kWeighted, G>(wg, s, g));
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * out_gstride + row * feat + f] = acc[g];
    }
  }
}

// K2 (kWeighted, !kRound) and K6 (G = 1, kRound).
template <typename T, int G, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kHdWarps * kWarp)
hd_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
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
      const T xv = live ? x[c * feat + f] : groot::zero<T>();
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = groot::accumulate<kWeighted, kRound>(
            acc[g], xv, groot::slot_weight<kWeighted, G>(wg, s, g));
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

// --- K4 / K5's MXU body: tensor-core one-hot reduction ----------------------

// mma.sync shapes: f32 streams run m16n8k8 TF32, bf16 streams m16n8k16 bf16.
// A lane holds kPer slots of each k-step: its B rows, which are also its A
// columns (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16").
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kK = 8;
  static constexpr int kPer = 2;
  static constexpr uint32_t kOne = 0x3f800000u;  // 1.0 in TF32 (= f32 bits)
  // lane's i-th slot of a k-step: rows tig and tig + 4
  static __device__ __forceinline__ int slot(int tig, int i) { return tig + 4 * i; }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPer = 4;
  static constexpr uint32_t kOne = 0x3f80u;  // 1.0 in bf16
  // rows 2*tig, 2*tig + 1, 2*tig + 8, 2*tig + 9
  static __device__ __forceinline__ int slot(int tig, int i) {
    return 2 * tig + (i & 1) + 8 * (i >> 1);
  }
};

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One k-step's MMAs for one group: A is the one-hot fragment, p the lane's
// kPer weighted messages (its B fragment before packing).
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         const float (&p)[2]) {
  // TF32 high part, then the residual (exact in f32) rounded to TF32
  const uint32_t h0 = tf32_bits(p[0]), h1 = tf32_bits(p[1]);
  const uint32_t l0 = tf32_bits(p[0] - __uint_as_float(h0));
  const uint32_t l1 = tf32_bits(p[1] - __uint_as_float(h1));
  mma_tf32(c, a, h0, h1);
  mma_tf32(c, a, l0, l1);
}

__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16 (&p)[4]) {
  mma_bf16(c, a, pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
}

// out[g, r, :] = sum over the slots k of row r of (x[cols[k]] * wg[k, g]),
// the product rounded to T, as (one-hot A) @ B on the tensor cores.
template <typename T, int G, bool kWeighted>
__global__ void __launch_bounds__(kMmaWarps * kWarp)
ld_mma_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
              const T* __restrict__ wg, float* __restrict__ out,
              int64_t rows, int deg, int feat, int64_t out_gstride) {
  using M = Mma<T>;
  const int lane = threadIdx.x & (kWarp - 1);
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kMmaWarps + threadIdx.x / kWarp) * kTileRows;
  if (row0 >= rows) return;
  const int64_t slot0 = row0 * deg;
  const int64_t slots = rows * deg;
  const int tile_slots = kTileRows * deg;
  for (int f0 = 0; f0 < feat; f0 += 8) {
    const int f = f0 + gid;  // B column of this lane
    const bool live = f < feat;
    float c[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) c[g][0] = c[g][1] = c[g][2] = c[g][3] = 0.f;
    for (int k0 = 0; k0 < tile_slots; k0 += M::kK) {
      // A: tile row r owns tile slots [r*d, (r+1)*d); this lane holds rows
      // gid and gid + 8 at its slot columns
      uint32_t on[M::kPer][2];
      T p[G][M::kPer];
#pragma unroll
      for (int i = 0; i < M::kPer; ++i) {
        const int k = k0 + M::slot(tig, i);
        const int r = k / deg;
        on[i][0] = r == gid ? M::kOne : 0u;
        on[i][1] = r == gid + 8 ? M::kOne : 0u;
        const int64_t s = slot0 + k;
        T xv = groot::zero<T>();
        if (s < slots && live) xv = x[static_cast<int64_t>(cols[s]) * feat + f];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if constexpr (kWeighted) {
            p[g][i] = s < slots ? groot::mul_round(xv, wg[s * G + g]) : groot::zero<T>();
          } else {
            p[g][i] = xv;
          }
        }
      }
      uint32_t a[4];
      if constexpr (M::kPer == 2) {  // m16n8k8: a0 (gid, k_0) a1 (gid+8, k_0) a2 (gid, k_1) a3 (gid+8, k_1)
        a[0] = on[0][0];
        a[1] = on[0][1];
        a[2] = on[1][0];
        a[3] = on[1][1];
      } else {  // m16n8k16: pairs (k_0, k_1) then (k_2, k_3), rows gid / gid+8
        a[0] = on[0][0] | (on[1][0] << 16);
        a[1] = on[0][1] | (on[1][1] << 16);
        a[2] = on[2][0] | (on[3][0] << 16);
        a[3] = on[2][1] | (on[3][1] << 16);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) mma_step(c[g], a, p[g]);
    }
    // C: c0, c1 at (gid, 2*tig + {0, 1}); c2, c3 at (gid + 8, 2*tig + {0, 1})
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + gid + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int fo = f0 + 2 * tig + j;
        if (fo >= feat) continue;
#pragma unroll
        for (int g = 0; g < G; ++g) out[g * out_gstride + row * feat + fo] = c[g][2 * h + j];
      }
    }
  }
}

// --- launchers ----------------------------------------------------------------

template <typename T, int G, bool kWeighted, bool kRound>
int launch_ld(const void* x, const void* cols, const void* wg, void* out, int64_t rows,
              int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kLdWarps - 1) / kLdWarps));
  ld_kernel<T, G, kWeighted, kRound><<<grid, kLdWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<float*>(out), rows, deg, feat, out_gstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool kWeighted, bool kRound>
int launch_hd(const void* x, const void* cols, const void* wg, const void* row_chunks,
              void* out, int64_t n_hd, int e_t, int feat, int64_t out_gstride,
              cudaStream_t stream) {
  hd_kernel<T, G, kWeighted, kRound><<<static_cast<unsigned>(n_hd), kHdWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<const int32_t*>(row_chunks), static_cast<float*>(out), e_t, feat,
      out_gstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool kWeighted>
int launch_mma(const void* x, const void* cols, const void* wg, void* out, int64_t rows,
               int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const dim3 grid(static_cast<unsigned>((tiles + kMmaWarps - 1) / kMmaWarps));
  ld_mma_kernel<T, G, kWeighted><<<grid, kMmaWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<float*>(out), rows, deg, feat, out_gstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ld(int groups, const void* x, const void* cols, const void* wg, void* out,
                int64_t rows, int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: return launch_ld<T, 1, true, false>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 2: return launch_ld<T, 2, true, false>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 3: return launch_ld<T, 3, true, false>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 4: return launch_ld<T, 4, true, false>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_hd(int groups, const void* x, const void* cols, const void* wg,
                const void* row_chunks, void* out, int64_t n_hd, int e_t, int feat,
                int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: return launch_hd<T, 1, true, false>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream);
    case 2: return launch_hd<T, 2, true, false>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream);
    case 3: return launch_hd<T, 3, true, false>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream);
    case 4: return launch_hd<T, 4, true, false>(x, cols, wg, row_chunks, out, n_hd, e_t, feat, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_mma(int groups, const void* x, const void* cols, const void* wg, void* out,
                 int64_t rows, int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: return launch_mma<T, 1, true>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 2: return launch_mma<T, 2, true>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 3: return launch_mma<T, 3, true>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 4: return launch_mma<T, 4, true>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: ungrouped bucket, optional weight, VPU or MXU body
template <typename T>
int dispatch_bucket(const void* x, const void* cols, const void* w, void* out, int64_t rows,
                    int deg, int feat, int mxu, cudaStream_t stream) {
  if (mxu) {
    return w ? launch_mma<T, 1, true>(x, cols, w, out, rows, deg, feat, 0, stream)
             : launch_mma<T, 1, false>(x, cols, w, out, rows, deg, feat, 0, stream);
  }
  return w ? launch_ld<T, 1, true, true>(x, cols, w, out, rows, deg, feat, 0, stream)
           : launch_ld<T, 1, false, true>(x, cols, w, out, rows, deg, feat, 0, stream);
}

// K6: ungrouped HD rows, optional weight
template <typename T>
int dispatch_hd_ungrouped(const void* x, const void* cols, const void* w, const void* row_chunks,
                          void* out, int64_t n_hd, int e_t, int feat, cudaStream_t stream) {
  return w ? launch_hd<T, 1, true, true>(x, cols, w, row_chunks, out, n_hd, e_t, feat, 0, stream)
           : launch_hd<T, 1, false, true>(x, cols, w, row_chunks, out, n_hd, e_t, feat, 0, stream);
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

extern "C" int groot_ld_grouped_mxu(const void* x, const void* cols, const void* wg, void* out,
                                    int64_t rows, int deg, int groups, int feat,
                                    int64_t out_gstride, int bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_mma<__nv_bfloat16>(groups, x, cols, wg, out, rows, deg, feat, out_gstride, st)
              : dispatch_mma<float>(groups, x, cols, wg, out, rows, deg, feat, out_gstride, st);
}

// w may be null (no weights: the plain A @ x)
extern "C" int groot_ld_bucket(const void* x, const void* cols, const void* w, void* out,
                               int64_t rows, int deg, int feat, int mxu, int bf16,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bucket<__nv_bfloat16>(x, cols, w, out, rows, deg, feat, mxu, st)
              : dispatch_bucket<float>(x, cols, w, out, rows, deg, feat, mxu, st);
}

extern "C" int groot_hd(const void* x, const void* cols, const void* w, const void* row_chunks,
                        void* out, int64_t n_hd, int e_t, int feat, int bf16, void* stream) {
  if (n_hd <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_hd_ungrouped<__nv_bfloat16>(x, cols, w, row_chunks, out, n_hd, e_t, feat, st)
              : dispatch_hd_ungrouped<float>(x, cols, w, row_chunks, out, n_hd, e_t, feat, st);
}
