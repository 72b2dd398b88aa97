// Degree-bucketed SpMM walks for Hopper (sm_90a), plain C interface.
//
// Grouped walks (G slot x polarity groups, staged weights wg of G columns):
// K1 groot_ld_grouped replaces the Pallas kernel
//    src/repro/kernels/groot_spmm.py:_ld_kernel_grouped (launched by
//    ld_grouped_apply).  For one ELL bucket of degree d:
//        out[g, r, :] = sum_{k<d} wg[r*d+k, g] * x[cols[r*d+k], :]
// K2 groot_hd (round_product = 0) replaces src/repro/kernels/groot_spmm.py:
//    _hd_kernel_grouped (launched by hd_grouped_apply): the same sum over a
//    high-degree (HD) row whose edges come as consecutive e_t-edge chunks.
// K4 groot_ld_grouped_mxu replaces src/repro/kernels/groot_spmm.py:
//    _ld_kernel_grouped_mxu (ld_grouped_apply(mxu=True) for d > 1): the K1 sum
//    as one-hot block-diagonal (16, 16*d) @ (x[cols] * wg) products on the
//    tensor cores, each product x * w rounded to the stream dtype first.
//
// Ungrouped walks (an optional per-slot weight w; the product x * w is taken
// in the stream dtype, as the reference pre-weights its messages):
// K5 groot_ld_bucket replaces src/repro/kernels/groot_spmm.py:_ld_kernel and
//    :_ld_kernel_mxu (launched by ld_bucket_apply):
//        out[r, :] = sum_{k<d} x[cols[r*d+k], :] (* w[r*d+k]).
//    Both bodies gather through K4's staged ring at one group: the VPU body
//    (ld_staged_kernel) sums the staged rows on the f32 units, the MXU body
//    is K4's ld_onehot_staged_kernel at G = 1.
// K6 groot_hd (round_product = 1) replaces src/repro/kernels/groot_spmm.py:
//    _hd_kernel (launched by hd_apply): K5's sum over an HD row's chunks, K2's
//    body at one group with K5's rounding.
//
// Bound on the H100: memory.  Each edge slot costs one F-wide row read of x
// plus G weights and one index, for G*F multiply-adds: about 0.5-1 operation
// per byte, far under the ~20 f32 operations per byte at which the card's
// 67 TFLOP/s f32 rate would bind.  The least bytes are the distinct x rows the
// bucket touches, the staged weights, the column indices and the f32 output,
// each moved once, at 3.35 TB/s.  K2/K6 at csa-1024 (2,048 HD rows of degree
// 1,024, 4,096 chunks of 512): at F = 32 f32, G = 2, 160 MB or 0.048 ms;
// but each x row is read by two HD rows, and those rows (134 MB) exceed the
// 50 MB L2, so without reuse the floor is about 294 MB, 0.088 ms.  K4's
// one-hot products do 16x more tensor core work than the sums need (a
// (16, 16*d) operand of which 1/16 is ones), still far under the tensor
// cores' rate (495 TFLOP/s TF32, 989 bf16), so what K4 reads decides its
// time: each slot's index, weights and x row once.
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
//  * K2/K6 (hd_staged_kernel, then hd_combine_kernel): a CUDA grid runs in no
//    order, so the TPU kernel's trick of keeping a row's output resident
//    across consecutive grid steps does not carry over; its structure does: a
//    sum per chunk, then each row's chunks added in order.  The work unit is a
//    chunk, not a row, so 4,096 chunks fill a persistent grid of every warp
//    the card keeps resident, which one row a block (2,048 blocks of one
//    dependent index -> row load after another) did not.  Each warp gathers
//    its chunks through a cp.async ring in its own shared memory, as the
//    staged bodies do: indices and G weights two stages ahead, x rows (16-byte
//    pieces) one stage ahead, packed so a pass's lanes read consecutive bytes.
//    A lane owns 16 bytes of a row, so a warp sums several slots a pass (4 at
//    F = 32 f32, 32 at F = 4: every lane works at the first layer's width).
//    The lanes of a column are combined by shuffles in a fixed tree, the chunk
//    sums go to an f32 scratch, and a second pass adds each row's in chunk
//    order: no float atomics, two launches give the same bits.  x is read in
//    place at any width: the body takes x's row stride and a 32-column slice's
//    first column, copies the real columns in pieces that x's rows are aligned
//    to (16, 8 or 4 bytes) and zero-fills the rest of the staged row, so no
//    launch copies x (bf16 rows of an odd width, 2-byte aligned, are the
//    exception: groot_spmm.py pads them).
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
//  * K5 (both bodies) walks the same ring at one group, so each slot's
//    index, weight and x row are read once (K5's first bodies read them once
//    per 8-feature pass, or waited on one dependent index -> row load after
//    another per warp).  The MXU body is K4's kernel at G = 1, with an
//    unweighted variant whose products are x itself.  The VPU body
//    (ld_staged_kernel) sums the staged rows with f32 adds: each lane owns
//    16 bytes of a row (the whole row when it is narrower), so a 16-row
//    tile's rows share the warp (4 rows a pass at F = 32 f32, all 16 at
//    F = 4), each product x * w rounded to the stream dtype and the slots
//    of a row summed in ascending order, and the lane stores its 16 or 32
//    bytes of each row at once.  K1 at one group runs the same body with
//    K1's rounding (widen, then fmaf).
//  * Widths: the staged bodies are built for rows of 4, 8, 16 or 32
//    features.  The wrappers zero-pad x to the next of these (or to a
//    multiple of 32, each 32-column slice of a wider row copied apart and
//    launched on its own), and the kernels store all of a slice's columns
//    with vector stores; a slice with padded columns, or an output whose
//    rows those stores cannot reach, goes through a scratch buffer
//    (groot_spmm.py: stage_width).  At the model's widths nothing is copied
//    and no store or row address differs from a body built for that width
//    alone.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64
// (G * rows * F passes 2^31 for batches of the largest designs).
#include "mma.cuh"
#include "staged.cuh"

namespace {

using groot::kWarp;

constexpr int kLdWarps = 8;   // destination rows per LD block (one per warp)

// K1 at G = 2..4 (one group runs ld_staged_kernel).
template <typename T, int G>
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
        acc[g] = groot::accumulate<true, false>(acc[g], xv, wg[s * G + g]);
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * out_gstride + row * feat + f] = acc[g];
    }
  }
}

// --- The fragment shapes of K4 and K5's MXU body ---------------------------

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

// --- K4 and K5's MXU body: staged gather, one pass per tile -----------------

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
// the product rounded to T (x itself without weights), as (one-hot A) @ B
// with B = the G products of a slot side by side: each slot's index,
// weights and x row are read once.  Output rows out_rstride floats apart
// (8-byte aligned).
template <typename T, int G, int F, bool kWeighted>
__global__ void __launch_bounds__(kOneHotWarps * kWarp, 2)
ld_onehot_staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                        const T* __restrict__ wg, float* __restrict__ out, int64_t rows,
                        int ld2, int64_t out_gstride, int64_t out_rstride) {
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

  groot::run_walk<T, F, kWeighted>(ring, walk, cols, wg, x, lane, key,
                                   [&](const groot::Chunk& c, const unsigned char* staged,
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
        for (int g = 0; g < G; ++g)
          wv[i][g] = kWeighted && live ? ws[p * G + g] : groot::zero<T>();
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
          if constexpr (!kWeighted) {  // one group: x itself (F = 4: columns past 4 are padding)
            pr[i] = F >= 8 || gid < 4 ? xv[i][F >= 8 ? nt % S::kXF : 0] : groot::zero<T>();
          } else if constexpr (F >= 8) {
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
            *reinterpret_cast<float2*>(out + g * out_gstride + row * out_rstride + f) =
                make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < S::kTiles; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  });
}

// --- K5's VPU body (and K1 at one group): staged rows, f32 adds --------------

constexpr int kSumWarps = 8;  // warps a block, each with its own ring

// How a warp's lanes share a 16-row tile of rows of F T: each lane reads
// kVec consecutive features (16 bytes, or the whole row when narrower), so
// kLanes lanes cover a row and one pass covers kAtOnce rows; a lane owns
// kRows rows of the tile (rows r0, r0 + kAtOnce, ...; none when r0 >= 16).
template <typename T, int F>
struct SumShape {
  static_assert(F == 4 || F == 8 || F == 16 || F == 32, "F in {4, 8, 16, 32}");
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kVecBytes = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kVec = kVecBytes / static_cast<int>(sizeof(T));
  static constexpr int kLanes = kRowBytes / kVecBytes;
  static constexpr int kAtOnce = kWarp / kLanes;
  static constexpr int kRows = kAtOnce >= groot::kTile ? 1 : groot::kTile / kAtOnce;
};

// out[r, :] = sum over the slots k of row r (ascending) of x[cols[k]] * w[k]
// (kRound: the product rounded to T; else widened and fused, K1's
// rounding), or of x[cols[k]] alone without weights; f32 sums, stored 16
// bytes at a time (output rows out_rstride floats, 16-byte aligned).  Three
// blocks an SM, as their rings' shared memory allows.
template <typename T, int F, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kSumWarps * kWarp, 3)
ld_staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                 const T* __restrict__ w, float* __restrict__ out, int64_t rows, int ld2,
                 int64_t out_rstride) {
  using S = SumShape<T, F>;
  using Ring = groot::Ring<T, 1>;
  extern __shared__ __align__(128) unsigned char staged_smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int v = lane % S::kLanes, r0 = lane / S::kLanes;
  Ring& ring = reinterpret_cast<Ring*>(staged_smem)[warp];
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kSumWarps + warp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kSumWarps;
  const groot::Walk walk(rows, ld2, wid, warps, groot::walk_steps(rows, 1, wid, warps));
  // a quarter warp (16-byte loads) reads 8 / kLanes rows at once, kLanes
  // units each: row r's units move by r * kLanes, so they hit distinct banks
  const auto key = [ld2](int, int t) { return ((t >> ld2) * S::kLanes) & 7; };

  float acc[S::kRows][S::kVec];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
#pragma unroll
    for (int j = 0; j < S::kVec; ++j) acc[i][j] = 0.f;

  groot::run_walk<T, F, kWeighted>(ring, walk, cols, w, x, lane, key,
                                   [&](const groot::Chunk& c, const unsigned char* staged,
                                       const T* ws) {
#pragma unroll
    for (int i = 0; i < S::kRows; ++i) {
      const int r = r0 + i * S::kAtOnce;
      if (r >= groot::kTile) continue;
      const int lo = max(r << ld2, c.begin) - c.begin;
      const int hi = min((r + 1) << ld2, c.begin + c.n) - c.begin;
      for (int p = lo; p < hi; ++p) {
        T xv[S::kVec];
        groot::load_line(xv, staged + p * groot::kLine, v * S::kVecBytes, key(p, c.begin + p));
        const T wp = kWeighted ? ws[p] : groot::zero<T>();
#pragma unroll
        for (int j = 0; j < S::kVec; ++j)
          acc[i][j] = groot::accumulate<kWeighted, kRound>(acc[i][j], xv[j], wp);
      }
    }
  }, [&](int64_t tile) {
#pragma unroll
    for (int i = 0; i < S::kRows; ++i) {
      const int r = r0 + i * S::kAtOnce;
      const int64_t row = tile * groot::kTile + r;
      if (r < groot::kTile && row < rows) {
        float* dst = out + row * out_rstride + v * S::kVec;
#pragma unroll
        for (int j = 0; j < S::kVec; j += 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
#pragma unroll
      for (int j = 0; j < S::kVec; ++j) acc[i][j] = 0.f;
    }
  });
}

// --- K2 and K6: HD chunks, then their rows ----------------------------------

constexpr int kHdWarps = 8;  // warps a block, each with its own ring

// How a warp's lanes share staged rows of F T (the staged width): as K5's
// VPU body shares them (a lane reads kVec consecutive features, kLanes lanes
// a row, kAtOnce rows a pass), but the rows are packed one after another in
// a ring stage, so the lanes of a pass read 32 * kVecBytes consecutive bytes
// (no bank conflict, no permutation needed).  A stage holds kSlots slots:
// 4 KB of rows at 64 and 128 bytes a row, 1-2 KB of narrower ones (a ring
// small enough for two blocks an SM at every G), at least one slot a lane.
template <typename T, int F>
struct HdShape : SumShape<T, F> {
  static constexpr int kRow = SumShape<T, F>::kRowBytes;
  static constexpr int kRowLog = kRow == 8 ? 3 : kRow == 16 ? 4 : kRow == 32 ? 5 : kRow == 64 ? 6 : 7;
  static constexpr int kSlots = kRow >= 128 ? 32 : kRow >= 32 ? 64 : 128;
};

// One warp's shared memory: two row stages, three meta stages (indices and
// G weights a slot), as in staged.cuh's ring (a third row stage in flight
// measured no faster).
template <typename T, int G, int F>
struct alignas(128) HdRing {
  using S = HdShape<T, F>;
  unsigned char rows[2][S::kSlots * S::kRow];
  int32_t cols[3][S::kSlots];
  T w[3][S::kSlots * G];
};

// One stage of a warp's walk: slots [start, start + n) of chunk ``unit``;
// ``last``: the chunk's last stage.
struct HdStep {
  int64_t unit, start;
  int n;
  bool last;
};

// part[u, g, :] = sum over the e_t slots k of chunk u of x[cols[k]] * w[k, g]
// (K2: widened to f32 and fused, fmaf; K6, kRound: the product rounded to
// T; without weights x alone), over F columns of x's rows (x_stride T
// apart, the first valid_bytes copied, the rest zero-filled).  Warps stride
// over the chunks (a persistent grid); each gathers a chunk through its
// ring: a stage's indices and weights two stages ahead, its x rows one stage
// ahead, in pieces of 2^piece_log bytes (16, 8 or 4: what x's rows are
// aligned to).  A lane adds the slots of its residue class (slot mod
// kAtOnce) in ascending order, then the kAtOnce lanes of a column are
// combined by a butterfly of shuffles: a fixed order, no atomics.
template <typename T, int G, int F, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kHdWarps * kWarp, 2)
hd_staged_kernel(const T* __restrict__ x, int64_t x_stride, const int32_t* __restrict__ cols,
                 const T* __restrict__ w, float* __restrict__ part, int64_t units, int e_t,
                 int valid_bytes, int piece_log) {
  using S = HdShape<T, F>;
  using Ring = HdRing<T, G, F>;
  using groot::cp_async;
  extern __shared__ __align__(128) unsigned char staged_smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int v = lane % S::kLanes, r0 = lane / S::kLanes;
  Ring& ring = reinterpret_cast<Ring*>(staged_smem)[warp];
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kHdWarps + warp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kHdWarps;
  const int per_unit = (e_t + S::kSlots - 1) / S::kSlots;
  const int64_t count = (wid < units ? (units - 1 - wid) / warps + 1 : 0) * per_unit;
  if (count == 0) return;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const int64_t row_bytes = x_stride * static_cast<int64_t>(sizeof(T));
  const int per_log = S::kRowLog - piece_log;  // log2 of the pieces a staged row

  const auto at = [&](int64_t q) {
    HdStep s;
    const int64_t i = q / per_unit;
    const int c = static_cast<int>(q - i * per_unit);
    s.unit = wid + i * warps;
    s.start = s.unit * e_t + c * S::kSlots;
    s.n = min(S::kSlots, e_t - c * S::kSlots);
    s.last = c == per_unit - 1;
    return s;
  };
  const auto issue_meta = [&](int m, const HdStep& s) {
    const int col_bytes = s.n * 4;
    const unsigned char* csrc = reinterpret_cast<const unsigned char*>(cols + s.start);
    for (int off = lane * 16; off < col_bytes; off += kWarp * 16)
      cp_async<16>(groot::smem_u32(&ring.cols[m][0]) + off, csrc + off, min(16, col_bytes - off));
    if constexpr (kWeighted) {
      const int w_bytes = s.n * G * static_cast<int>(sizeof(T));
      const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(w + s.start * G);
      for (int off = lane * 16; off < w_bytes; off += kWarp * 16)
        cp_async<16>(groot::smem_u32(&ring.w[m][0]) + off, wsrc + off, min(16, w_bytes - off));
    }
  };
  const auto issue_rows = [&](int r, int m, const HdStep& s) {
    const uint32_t base = groot::smem_u32(&ring.rows[r][0]);
    const int piece = 1 << piece_log;
    for (int i = lane; i < (s.n << per_log); i += kWarp) {
      const int p = i >> per_log, byte = (i & ((1 << per_log) - 1)) << piece_log;
      const unsigned char* row = xb + ring.cols[m][p] * row_bytes;
      const int bytes = min(piece, max(valid_bytes - byte, 0));  // 0: zero-filled
      const unsigned char* src = bytes ? row + byte : row;
      const uint32_t dst = base + p * S::kRow + byte;
      if (piece_log == 4) {
        cp_async<16>(dst, src, bytes);
      } else if (piece_log == 3) {
        cp_async<8>(dst, src, bytes);
      } else {
        cp_async<4>(dst, src, bytes);
      }
    }
  };

  float acc[G][S::kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < S::kVec; ++j) acc[g][j] = 0.f;

  // Step q commits two copy groups, meta q + 2 and rows q + 1; at the top
  // of step q the groups in flight are meta q + 1 and rows q.
  issue_meta(0, at(0));
  groot::cp_async_commit();
  if (count > 1) issue_meta(1, at(1));
  groot::cp_async_commit();
  groot::cp_async_wait<1>();  // meta 0 has landed
  __syncwarp();
  issue_rows(0, 0, at(0));
  groot::cp_async_commit();
  int ms = 0;  // meta stage of step q (rows stage: q % 2)
  for (int64_t q = 0; q < count; ++q) {
    const HdStep s = at(q);
    __syncwarp();  // every lane is done with the stages the next copies overwrite
    if (q + 2 < count) issue_meta((ms + 2) % 3, at(q + 2));
    groot::cp_async_commit();
    groot::cp_async_wait<1>();  // meta q + 1 and rows q have landed
    __syncwarp();
    if (q + 1 < count) issue_rows(static_cast<int>((q + 1) & 1), (ms + 1) % 3, at(q + 1));
    groot::cp_async_commit();
    const unsigned char* staged = ring.rows[q & 1];
    const T* ws = ring.w[ms];
    for (int p = r0; p < s.n; p += S::kAtOnce) {
      T xv[S::kVec];
      const unsigned char* at_row = staged + p * S::kRow + v * S::kVecBytes;
      if constexpr (S::kVecBytes == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(at_row);
        memcpy(&xv[0], &u, 16);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(at_row);
        memcpy(&xv[0], &u, 8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T wp = kWeighted ? ws[p * G + g] : groot::zero<T>();
#pragma unroll
        for (int j = 0; j < S::kVec; ++j)
          acc[g][j] = groot::accumulate<kWeighted, kRound>(acc[g][j], xv[j], wp);
      }
    }
    if (s.last) {  // the chunk's sum: residue classes by a butterfly, then stored
#pragma unroll
      for (int off = S::kLanes; off < kWarp; off <<= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < S::kVec; ++j)
            acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
      if (r0 == 0) {
        float* dst = part + s.unit * (G * F) + v * S::kVec;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < S::kVec; j += 4)
            *reinterpret_cast<float4*>(dst + g * F + j) =
                make_float4(acc[g][j], acc[g][j + 1], acc[g][j + 2], acc[g][j + 3]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < S::kVec; ++j) acc[g][j] = 0.f;
    }
    ms = ms == 2 ? 0 : ms + 1;
  }
  groot::cp_async_wait<0>();
}

// out[g, r, f] = the chunk sums of HD row r added in chunk order (part of
// its first chunk, plus the next, ...), for the ``valid`` first of the
// ``feat`` columns a chunk sum has; output rows out_rstride floats apart.
__global__ void __launch_bounds__(256)
hd_combine_kernel(const float* __restrict__ part, const int32_t* __restrict__ row_chunks,
                  float* __restrict__ out, int64_t n_hd, int groups, int feat, int valid,
                  int64_t out_gstride, int64_t out_rstride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_hd * groups * valid) return;
  const int f = static_cast<int>(i % valid);
  const int64_t t = i / valid;
  const int g = static_cast<int>(t % groups);
  const int64_t row = t / groups;
  const int64_t first = row_chunks[2 * row];
  const int count = row_chunks[2 * row + 1];
  const int64_t step = static_cast<int64_t>(groups) * feat;
  const float* p = part + first * step + g * feat + f;
  float sum = count > 0 ? p[0] : 0.f;
  for (int c = 1; c < count; ++c) sum += p[c * step];
  out[g * out_gstride + row * out_rstride + f] = sum;
}

// --- launchers ----------------------------------------------------------------

template <typename T, int G>
int launch_ld(const void* x, const void* cols, const void* wg, void* out, int64_t rows,
              int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kLdWarps - 1) / kLdWarps));
  ld_kernel<T, G><<<grid, kLdWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<float*>(out), rows, deg, feat, out_gstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ld(int groups, const void* x, const void* cols, const void* wg, void* out,
                int64_t rows, int deg, int feat, int64_t out_gstride, cudaStream_t stream) {
  switch (groups) {  // one group: ld_staged_kernel (groot_ld_bucket, round = 0)
    case 2: return launch_ld<T, 2>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 3: return launch_ld<T, 3>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    case 4: return launch_ld<T, 4>(x, cols, wg, out, rows, deg, feat, out_gstride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One staged launch's shape: output rows out_rstride floats apart (groups
// out_gstride).
struct StagedArgs {
  const void* x;
  const void* cols;
  const void* w;  // G weights a slot, or null
  void* out;
  int64_t rows;
  int ld2;
  int64_t out_gstride, out_rstride;
};

// Launch a persistent staged kernel of ``warps`` warps a block, each with
// its own ring of Ring bytes, over the bucket's 16-row tiles.
template <typename Ring, typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int warps, int64_t rows, cudaStream_t stream,
                      Args... args) {
  const size_t smem = warps * sizeof(Ring);
  dim3 grid;
  const int64_t units = ((rows + groot::kTile - 1) / groot::kTile + warps - 1) / warps;
  const cudaError_t err = groot::persistent_grid(kernel, warps * kWarp, smem, units, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, warps * kWarp, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int F, bool kWeighted>
int launch_onehot(const StagedArgs& a, cudaStream_t stream) {
  return launch_persistent<groot::Ring<T, G>>(
      ld_onehot_staged_kernel<T, G, F, kWeighted>, kOneHotWarps, a.rows, stream,
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.cols),
      static_cast<const T*>(a.w), static_cast<float*>(a.out), a.rows, a.ld2, a.out_gstride,
      a.out_rstride);
}

template <typename T, int F, bool kWeighted, bool kRound>
int launch_sum(const StagedArgs& a, cudaStream_t stream) {
  return launch_persistent<groot::Ring<T, 1>>(
      ld_staged_kernel<T, F, kWeighted, kRound>, kSumWarps, a.rows, stream,
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.cols),
      static_cast<const T*>(a.w), static_cast<float*>(a.out), a.rows, a.ld2, a.out_rstride);
}

// The staged bodies at one of their widths: Launch<F>::run(args...).
template <template <int> class Launch, typename... Args>
int by_feat(int feat, Args&&... args) {
  switch (feat) {
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int G>
struct OneHotAt {
  template <int F>
  struct W {
    static int run(const StagedArgs& a, cudaStream_t st) { return launch_onehot<T, G, F, true>(a, st); }
  };
};

template <typename T>
struct OneHotPlain {  // one group, no weights
  template <int F>
  struct W {
    static int run(const StagedArgs& a, cudaStream_t st) { return launch_onehot<T, 1, F, false>(a, st); }
  };
};

template <typename T, bool kWeighted, bool kRound>
struct SumAt {
  template <int F>
  struct W {
    static int run(const StagedArgs& a, cudaStream_t st) {
      return launch_sum<T, F, kWeighted, kRound>(a, st);
    }
  };
};

template <typename T>
int dispatch_onehot(int groups, int feat, const StagedArgs& a, cudaStream_t st) {
  switch (groups) {
    case 1: return by_feat<OneHotAt<T, 1>::template W>(feat, a, st);
    case 2: return by_feat<OneHotAt<T, 2>::template W>(feat, a, st);
    case 3: return by_feat<OneHotAt<T, 3>::template W>(feat, a, st);
    case 4: return by_feat<OneHotAt<T, 4>::template W>(feat, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5 (and K1 at one group): the MXU body (d > 1) or the VPU body, with or
// without a weight; ``round``: K5's product rounded to T, else K1's fmaf
template <typename T>
int dispatch_bucket(int feat, int mxu, int round_product, const StagedArgs& a, cudaStream_t st) {
  if (mxu) {
    if (a.ld2 == 0 || !round_product) return static_cast<int>(cudaErrorInvalidValue);
    return a.w ? by_feat<OneHotAt<T, 1>::template W>(feat, a, st)
               : by_feat<OneHotPlain<T>::template W>(feat, a, st);
  }
  if (!a.w) return by_feat<SumAt<T, false, true>::template W>(feat, a, st);
  return round_product ? by_feat<SumAt<T, true, true>::template W>(feat, a, st)
               : by_feat<SumAt<T, true, false>::template W>(feat, a, st);
}

// One HD launch's shape (see groot_hd).
struct HdArgs {
  const void* x;
  int64_t x_stride;
  const void* cols;
  const void* w;  // G weights a slot, or null
  const void* row_chunks;
  void* part;
  void* out;
  int64_t n_chunks, n_hd;
  int e_t, valid, piece_log;
  int64_t out_gstride, out_rstride;
};

template <typename T, int G, int F, bool kWeighted, bool kRound>
int launch_hd(const HdArgs& a, cudaStream_t stream) {
  using S = HdShape<T, F>;
  if (a.piece_log < 2 || a.piece_log > 4 || (1 << a.piece_log) > S::kRow || a.valid > F)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = hd_staged_kernel<T, G, F, kWeighted, kRound>;
  const size_t smem = kHdWarps * sizeof(HdRing<T, G, F>);
  dim3 grid;
  cudaError_t err = groot::persistent_grid(kernel, kHdWarps * kWarp, smem,
                                           (a.n_chunks + kHdWarps - 1) / kHdWarps, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kHdWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(a.x), a.x_stride, static_cast<const int32_t*>(a.cols),
      static_cast<const T*>(a.w), static_cast<float*>(a.part), a.n_chunks, a.e_t,
      a.valid * static_cast<int>(sizeof(T)), a.piece_log);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = a.n_hd * G * a.valid;
  hd_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<const int32_t*>(a.row_chunks),
      static_cast<float*>(a.out), a.n_hd, G, F, a.valid, a.out_gstride, a.out_rstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool kWeighted, bool kRound>
struct HdAt {
  template <int F>
  struct W {
    static int run(const HdArgs& a, cudaStream_t st) {
      return launch_hd<T, G, F, kWeighted, kRound>(a, st);
    }
  };
};

// K6 (round_product: one group, the product rounded to T, or no weight) or
// K2 (G = 1-4 weights, widened and fused)
template <typename T>
int dispatch_hd(int groups, int feat, int round_product, const HdArgs& a, cudaStream_t st) {
  if (round_product) {
    if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
    return a.w ? by_feat<HdAt<T, 1, true, true>::template W>(feat, a, st)
               : by_feat<HdAt<T, 1, false, true>::template W>(feat, a, st);
  }
  if (!a.w) return static_cast<int>(cudaErrorInvalidValue);
  switch (groups) {
    case 1: return by_feat<HdAt<T, 1, true, false>::template W>(feat, a, st);
    case 2: return by_feat<HdAt<T, 2, true, false>::template W>(feat, a, st);
    case 3: return by_feat<HdAt<T, 3, true, false>::template W>(feat, a, st);
    case 4: return by_feat<HdAt<T, 4, true, false>::template W>(feat, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// log2 of a power-of-two degree, or -1
int log2_deg(int deg) {
  return deg < 1 || (deg & (deg - 1)) ? -1 : __builtin_ctz(static_cast<unsigned>(deg));
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

// feat: x's staged width (4, 8, 16 or 32); all feat columns are stored
extern "C" int groot_ld_grouped_mxu(const void* x, const void* cols, const void* wg, void* out,
                                    int64_t rows, int deg, int groups, int feat,
                                    int64_t out_gstride, int64_t out_rstride, int bf16,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int ld2 = log2_deg(deg);
  if (ld2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const StagedArgs a{x, cols, wg, out, rows, ld2, out_gstride, out_rstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_onehot<__nv_bfloat16>(groups, feat, a, st)
              : dispatch_onehot<float>(groups, feat, a, st);
}

// w may be null (no weights: the plain A @ x); feat as for
// groot_ld_grouped_mxu
extern "C" int groot_ld_bucket(const void* x, const void* cols, const void* w, void* out,
                               int64_t rows, int deg, int feat, int64_t out_rstride, int mxu,
                               int round_product, int bf16, void* stream) {
  if (rows <= 0) return 0;
  const int ld2 = log2_deg(deg);
  if (ld2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const StagedArgs a{x, cols, w, out, rows, ld2, 0, out_rstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bucket<__nv_bfloat16>(feat, mxu, round_product, a, st)
              : dispatch_bucket<float>(feat, mxu, round_product, a, st);
}

// K2 (round_product = 0: G = 1-4 weights a slot, widened and fused) and K6
// (round_product = 1: one weight a slot or none, the product rounded to T)
// over the HD chunks, e_t slots each (e_t a multiple of 8).  x: the first
// column of a slice of staged width feat (4, 8, 16 or 32) of rows x_stride
// elements apart, ``valid`` of its columns real (the rest read as zeros),
// the rows and x aligned to 2^piece_log bytes (4, 8 or 16, at most a staged
// row); part: an f32 scratch of n_chunks * groups * feat floats for the
// chunk sums; out: the valid columns of each HD row, groups out_gstride and
// rows out_rstride floats apart.  Two launches: the chunk sums, then each
// row's sums added in chunk order.
extern "C" int groot_hd(const void* x, int64_t x_stride, const void* cols, const void* w,
                        const void* row_chunks, void* part, void* out, int64_t n_chunks,
                        int64_t n_hd, int e_t, int groups, int feat, int valid, int piece_log,
                        int64_t out_gstride, int64_t out_rstride, int round_product, int bf16,
                        void* stream) {
  if (n_hd <= 0) return 0;
  if (e_t < 1 || e_t % 8 || valid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const HdArgs a{x, x_stride, cols, w, row_chunks, part, out, n_chunks, n_hd, e_t, valid,
                 piece_log, out_gstride, out_rstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_hd<__nv_bfloat16>(groups, feat, round_product, a, st)
              : dispatch_hd<float>(groups, feat, round_product, a, st);
}
