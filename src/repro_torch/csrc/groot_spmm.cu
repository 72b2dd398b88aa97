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
//    as one-hot block-diagonal (16, 16*d) @ (x[cols] * wg) products on the
//    tensor cores, each product x * w rounded to the stream dtype first.
//
// Ungrouped walks (an optional per-slot weight w; the product x * w is taken
// in the stream dtype, as the reference pre-weights its messages):
// K5 groot_ld_bucket / groot_ld_bucket_mxu replace
//    src/repro/kernels/groot_spmm.py:_ld_kernel and :_ld_kernel_mxu (launched
//    by ld_bucket_apply):  out[r, :] = sum_{k<d} x[cols[r*d+k], :] (* w[r*d+k]).
//    The VPU body is K1's code at one group; the MXU body a one-hot
//    tensor-core walk like K4's.
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
// still far under the tensor cores' rate (495 TFLOP/s TF32, 989 bf16), so
// what K4 reads decides its time: each slot's index, weights and x row once.
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
//  * K4 (ld_onehot_staged_kernel): each warp walks 16-row tiles
//    (persistent grid, 8 warps a block) and reads every slot once: the
//    gather runs through a cp.async ring in the warp's shared memory
//    (staged.cuh), a chunk's indices and G weights (one 16-byte copy for
//    G = 4 f32) two chunks ahead, its x rows (all F features, 16-byte copies)
//    one chunk ahead, so the next chunk's gather is in flight while this one
//    runs its products.  One product a k-step serves every group: B is the G
//    groups' weighted messages side by side (N = G*F = 128 at the model's
//    width), built from the staged rows with each product x * w rounded to
//    the stream dtype, and split on f32 streams into a TF32 high part and a
//    TF32 residual (two m16n8k8 TF32 MMAs; bf16 streams one m16n8k16 bf16
//    MMA).  The one-hot A is exact and made in registers from the slot's
//    tile row by a shift (d is a power of two: no division).  Staged rows
//    are XOR-permuted by the reading slot's lane so that B's loads are free
//    of bank conflicts.  What the split loses is at most 2^-22 of each
//    product.
//  * K5's MXU body (ld_mma_kernel) keeps that first design at one group:
//    one warp owns a 16-row tile and issues mma.sync per 8-feature column
//    tile and per k-step of the tile's 16*d slots, the one-hot A made in
//    registers from the slot index, the weighted messages loaded straight
//    into the fragment registers.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64
// (G * rows * F passes 2^31 for batches of the largest designs).
#include "mma.cuh"
#include "staged.cuh"

namespace {

using groot::kWarp;

constexpr int kLdWarps = 8;   // destination rows per LD block (one per warp)
constexpr int kHdWarps = 8;   // warps sharing one HD row
constexpr int kMmaWarps = 4;  // 16-row tiles per K5 MXU block (one per warp)
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

// --- K5's MXU body (and the fragment shapes K4 shares) -----------------------

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

// One k-step's MMAs for one group: A is the one-hot fragment, p the lane's
// kPer weighted messages (its B fragment before packing).
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         const float (&p)[2]) {
  // TF32 high part, then the residual (exact in f32) rounded to TF32
  uint32_t h0, h1, l0, l1;
  groot::split_tf32(p[0], h0, l0);
  groot::split_tf32(p[1], h1, l1);
  groot::mma_tf32(c, a, h0, h1);
  groot::mma_tf32(c, a, l0, l1);
}

__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16 (&p)[4]) {
  groot::mma_bf16(c, a, groot::pack_bf16(p[0], p[1]), groot::pack_bf16(p[2], p[3]));
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

// --- K4: staged gather, one pass per tile, all groups in one product ---------

constexpr int kOneHotWarps = 8;  // warps a block, each with its own ring

// K4's B has N = G*F columns, group-major.  Lane column gid of n-tile nt:
//   F >= 8: group nt / (F/8), feature 8 * (nt % (F/8)) + gid (x value j = nt % (F/8));
//   F == 4: column 8 nt + gid: group 2 nt + gid / 4, feature gid % 4 (x value 0).
// Its C columns 2 tig, 2 tig + 1 sit at the same group and consecutive features.
template <int G, int F>
struct OneHotShape {
  static_assert(F == 4 || F == 8 || F == 16 || F == 32, "F in {4, 8, 16, 32}");
  static constexpr int kTiles = (G * F + 7) / 8;  // 8-column n-tiles
  static constexpr int kXF = F >= 8 ? F / 8 : 1;  // x values a lane reads per slot
  static __device__ __forceinline__ int feature(int j, int gid) {
    return F >= 8 ? 8 * j + gid : (gid & 3);
  }
};

// out[g, r, :] = sum over the slots k of row r of (x[cols[k]] * wg[k, g]),
// the product rounded to T, as (one-hot A) @ B with B = the G products of a
// slot side by side: each slot's index, weights and x row are read once.
template <typename T, int G, int F>
__global__ void __launch_bounds__(kOneHotWarps * kWarp, 2)
ld_onehot_staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                        const T* __restrict__ wg, float* __restrict__ out, int64_t rows,
                        int ld2, int64_t out_gstride) {
  using M = Mma<T>;
  using S = OneHotShape<G, F>;
  using Ring = groot::Ring<T, G>;
  extern __shared__ __align__(128) unsigned char staged_smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int gid = lane >> 2, tig = lane & 3;
  Ring& ring = reinterpret_cast<Ring*>(staged_smem)[warp];
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kOneHotWarps + warp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kOneHotWarps;
  const groot::Walk walk(rows, ld2, wid, warps, groot::walk_steps(rows, 1, wid, warps));
  // the lanes of one load read one slot per tig (f32: tig + 4i, bf16:
  // 2 tig + (i & 1) + 8 (i >> 1)), so slot p's units move by its tig
  constexpr int kShift = sizeof(T) == 4 ? 0 : 1;
  const auto key = [](int p, int) { return ((p >> kShift) & 3) << 1; };

  float acc[S::kTiles][4];
#pragma unroll
  for (int nt = 0; nt < S::kTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  groot::run_walk<T, F>(ring, walk, cols, wg, x, lane, key, [&](const groot::Chunk& c,
                                                               const unsigned char* staged,
                                                               const T* ws) {
    for (int k0 = 0; k0 < c.n; k0 += M::kK) {
      // A: tile row r owns tile slots [r*d, (r+1)*d); this lane holds rows
      // gid and gid + 8 at its slot columns (shifts: d is a power of two)
      uint32_t on[M::kPer][2];
      T xv[M::kPer][S::kXF], wv[M::kPer][G];
#pragma unroll
      for (int i = 0; i < M::kPer; ++i) {
        const int p = k0 + M::slot(tig, i);
        const int r = (c.begin + p) >> ld2;
        on[i][0] = r == gid ? M::kOne : 0u;
        on[i][1] = r == gid + 8 ? M::kOne : 0u;
        const bool live = p < c.n;
#pragma unroll
        for (int j = 0; j < S::kXF; ++j) {
          const int byte = S::feature(j, gid) * static_cast<int>(sizeof(T));
          xv[i][j] = live ? *reinterpret_cast<const T*>(
                                staged + groot::line_offset(p, byte, key(p, 0)))
                          : groot::zero<T>();
        }
#pragma unroll
        for (int g = 0; g < G; ++g) wv[i][g] = live ? ws[p * G + g] : groot::zero<T>();
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
      for (int nt = 0; nt < S::kTiles; ++nt) {
        T pr[M::kPer];
#pragma unroll
        for (int i = 0; i < M::kPer; ++i) {
          if constexpr (F >= 8) {
            pr[i] = groot::mul_round(xv[i][nt % S::kXF], wv[i][nt / S::kXF]);
          } else {  // group 2 nt + gid / 4; past G the column is padding
            const T w0 = 2 * nt < G ? wv[i][2 * nt < G ? 2 * nt : 0] : groot::zero<T>();
            const T w1 = 2 * nt + 1 < G ? wv[i][2 * nt + 1 < G ? 2 * nt + 1 : 0] : groot::zero<T>();
            pr[i] = groot::mul_round(xv[i][0], gid < 4 ? w0 : w1);
          }
        }
        mma_step(acc[nt], a, pr);
      }
    }
  }, [&](int64_t tile) {
      // C: c0, c1 at (gid, 2 tig + {0, 1}); c2, c3 at (gid + 8, 2 tig + {0, 1})
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = tile * groot::kTile + gid + 8 * h;
        if (row >= rows) continue;
#pragma unroll
        for (int nt = 0; nt < S::kTiles; ++nt) {
          const int g = F >= 8 ? nt / S::kXF : 2 * nt + (tig >> 1);
          const int f = F >= 8 ? 8 * (nt % S::kXF) + 2 * tig : 2 * (tig & 1);
          if (g < G)
            *reinterpret_cast<float2*>(out + g * out_gstride + row * F + f) =
                make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < S::kTiles; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  });
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

template <typename T, int G, int F>
int launch_onehot(const void* x, const void* cols, const void* wg, void* out, int64_t rows,
                  int ld2, int64_t out_gstride, cudaStream_t stream) {
  const size_t smem = kOneHotWarps * sizeof(groot::Ring<T, G>);
  auto kernel = ld_onehot_staged_kernel<T, G, F>;
  dim3 grid;
  const int64_t units = ((rows + groot::kTile - 1) / groot::kTile + kOneHotWarps - 1) / kOneHotWarps;
  const cudaError_t err = groot::persistent_grid(kernel, kOneHotWarps * kWarp, smem, units, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kOneHotWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<float*>(out), rows, ld2, out_gstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int dispatch_onehot_feat(int feat, const void* x, const void* cols, const void* wg, void* out,
                         int64_t rows, int ld2, int64_t out_gstride, cudaStream_t stream) {
  switch (feat) {
    case 4: return launch_onehot<T, G, 4>(x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 8: return launch_onehot<T, G, 8>(x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 16: return launch_onehot<T, G, 16>(x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 32: return launch_onehot<T, G, 32>(x, cols, wg, out, rows, ld2, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_onehot(int groups, int feat, const void* x, const void* cols, const void* wg,
                    void* out, int64_t rows, int ld2, int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {
    case 1: return dispatch_onehot_feat<T, 1>(feat, x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 2: return dispatch_onehot_feat<T, 2>(feat, x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 3: return dispatch_onehot_feat<T, 3>(feat, x, cols, wg, out, rows, ld2, out_gstride, stream);
    case 4: return dispatch_onehot_feat<T, 4>(feat, x, cols, wg, out, rows, ld2, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int onehot_call(const void* x, const void* cols, const void* wg, void* out, int64_t rows, int deg,
                int groups, int feat, int64_t out_gstride, int bf16, cudaStream_t stream) {
  if (deg < 1 || (deg & (deg - 1))) return static_cast<int>(cudaErrorInvalidValue);
  const int ld2 = __builtin_ctz(static_cast<unsigned>(deg));
  return bf16 ? dispatch_onehot<__nv_bfloat16>(groups, feat, x, cols, wg, out, rows, ld2,
                                               out_gstride, stream)
              : dispatch_onehot<float>(groups, feat, x, cols, wg, out, rows, ld2, out_gstride,
                                       stream);
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
  return onehot_call(x, cols, wg, out, rows, deg, groups, feat, out_gstride, bf16,
                     static_cast<cudaStream_t>(stream));
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
