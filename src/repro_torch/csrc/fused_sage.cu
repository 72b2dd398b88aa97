// Fused LD aggregate + weight matmul for Hopper (sm_90a), plain C interface.
//
// K3 (fused_ld_staged, G groups) replaces the Pallas kernel
//    src/repro/kernels/fused_sage.py:_fused_kernel_grouped (launched by
//    fused_ld_matmul_grouped).  For one ELL bucket of degree d:
//        out[r, :] = sum_g ( sum_{k<d} wg[r*d+k, g] * x[cols[r*d+k], :] ) @ W[g]
//    with W the (G, F, H) f32 weight stack of one SAGE layer.
// K7 (fused_ld_staged, one group) replaces
//    src/repro/kernels/fused_sage.py:_fused_kernel (launched by
//    fused_ld_matmul): the ungrouped form, one (F, H) matrix and an
//    optional per-slot weight whose product with x is rounded to the stream
//    dtype before the sum (the reference pre-weights its messages in x.dtype):
//        out[r, :] = ( sum_{k<d} x[cols[r*d+k], :] (* w[r*d+k]) ) @ W
//
// Bound on the H100: memory.  Per destination row K3 reads d rows of x, d*G
// weights and d indices and writes H f32 outputs, for d*G*F aggregation
// multiply-adds (f32, 67 TFLOP/s) and G*F*H contraction multiply-adds (on
// the tensor cores as three TF32 products, so at 495/3 TFLOP/s).  At the
// model's width (F = H = 32, G = 4, d = 2) the least bytes (the distinct x
// rows touched, the staged weights, the indices and the (R, H) f32 output,
// each moved once, at 3.35 TB/s) take about twice as long as those
// operations.  What binds in practice is the contraction: as an f32 FMA
// loop that reads two shared-memory operands per multiply-add (the first
// design of K3 and of K7) it takes 5-7x the bound, and as mma.sync m16n8k8
// (one B fragment load from shared memory per 16 rows) it is still slower
// than the wgmma contraction below (PERF.md).
//
// K3's design (fused_staged_kernel):
//  * One block is one warpgroup; it walks 64-row tiles (persistent grid),
//    warp w aggregating rows 16w .. 16w + 15.  The gather runs through a
//    cp.async ring in each warp's shared memory (staged.cuh): a chunk's
//    indices and weights land two chunks ahead, its x rows one chunk ahead,
//    so the next tile's gather is in flight while this one contracts.
//  * Aggregation exactly as before: each slot's weight and message widened
//    to f32 and fused with fmaf(w, x, acc), slots in ascending order.  The
//    lane keeps its aggregates in registers, already in the layout of the
//    TF32 A fragment: lane (gid, tig) owns subtile rows gid and gid + 8 and
//    the K = G*F columns whose features are tig*F/4 .. tig*F/4 + F/4 - 1
//    (the contraction's K order is free, so it is chosen to make each
//    lane's features contiguous: one or two 16-byte shared-memory loads per
//    staged row).  The aggregate never touches shared memory.
//  * The contraction is wgmma m64nNk8 TF32 with A from those registers and
//    B (W^T, K-major, no swizzle) from shared memory, where W's TF32 high
//    and low parts are split once per block: three products a k-step
//    (lo*hi, hi*lo, hi*hi; mma.cuh), f32 accumulation, one B read serving
//    64 rows.  H runs in 32-column chunks, every trip of the loop issuing
//    the same products, so no wgmma sits under a branch.  What the split
//    drops is under 2 * 2^-21 of each product.
//  * K = G*F is padded with zero columns to a multiple of 8 (G = 1 or 3 at
//    F = 4); rows past the bucket's end aggregate nothing and are not
//    stored.
//  * Widths: the body is built for rows of 4, 8, 16 or 32 features and W
//    of a multiple of 32 columns (32-column wgmma chunks), and stores every
//    column of its chunks with 8-byte stores.  The wrappers zero-pad x to
//    the next of these widths (or to a multiple of 32, each 32-column
//    slice of a wider row copied apart and launched on its own), W's rows
//    to match and its columns to a multiple of 32; a second slice, or W's
//    padded columns, go through a scratch output that is added or copied
//    into place (groot_spmm.py: stage_width, fused_sage.py).  At the
//    model's width (F = H = 32, and F = 4) nothing is copied and no store
//    is guarded.
// K7 runs the same body at G = 1 (fused_ld_staged with one group): with a
// weight, each product x * w rounded to the stream dtype before the f32 sum
// (the reference pre-weights its messages in x.dtype; K3 widens instead),
// or x alone without one.  Its contraction is a quarter of K3's, so its
// gather sets the pace.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64.
#include "mma.cuh"
#include "staged.cuh"

namespace {

using groot::kWarp;

constexpr int kStagedWarps = 4;  // one warpgroup a block, each warp its own ring
constexpr int kChunkN = 32;      // output columns a wgmma chunk

// --- K3 and K7: staged gather, contraction by wgmma ---------------------------

// A lane's share of a 16-row subtile's (16, G*F) aggregate: rows gid and
// gid + 8, and for each group the kFeat contiguous features tig*kFeat ..;
// entry e = g*kFeat + i is A-fragment column tig + 4*(e % 2) of k-step e / 2
// (the contraction's K order is free, so it is chosen for contiguous loads).
template <int G, int F>
struct FusedShape {
  static_assert(F == 4 || F == 8 || F == 16 || F == 32, "F in {4, 8, 16, 32}");
  static constexpr int kFeat = F / 4;
  static constexpr int kEntries = G * kFeat;
  static constexpr int kSteps = (kEntries + 1) / 2;  // k-steps of 8 (K padded with zeros)
};

// wgmma m64nNk8, f32 += tf32 x tf32, A from registers (the m16n8k8 A
// fragment, warp w of the warpgroup holding rows 16w ..), B from shared
// memory (K-major).  D: thread 4 g + q of warp w holds d[4j + e] at row
// 16w + g + 8(e / 2), column 8j + 2q + e % 2.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// W's TF32 high and low parts, each as the K-major B operand (W^T, hp rows
// of K) in 8-row x 16-byte core matrices: core matrix (ks, ng, kc) holds
// columns 8 ng .. 8 ng + 7 of W at the four K positions 4 kc .. 4 kc + 3 of
// k-step ks, at ((ks * NG + ng) * 2 + kc) * 128 bytes: K neighbours 128 bytes
// apart (LBO), 8-column groups 256 (SBO).  W's slice: group g's row f at
// w[g * w_gstride + f * hp], hp columns.
constexpr uint32_t kCoreLbo = 128, kCoreSbo = 256;

template <int G, int F>
__device__ void stage_w(float* __restrict__ w_hi, float* __restrict__ w_lo,
                        const float* __restrict__ w, int64_t w_gstride, int hp) {
  using S = FusedShape<G, F>;
  const int ngs = hp / 8;
  const int total = S::kSteps * ngs * 64;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int t = i & 3, r = (i >> 2) & 7, kc = (i >> 5) & 1;
    const int ng = (i >> 6) % ngs, ks = (i >> 6) / ngs;
    const int e = 2 * ks + kc, g = e / S::kFeat, f = t * S::kFeat + e % S::kFeat;
    const float v = g < G ? w[g * w_gstride + static_cast<int64_t>(f) * hp + ng * 8 + r] : 0.f;
    uint32_t hi, lo;
    groot::split_tf32(v, hi, lo);
    w_hi[i] = __uint_as_float(hi);
    w_lo[i] = __uint_as_float(lo);
  }
}

// out[rows of this warp's subtile, n0 .. n0 + N) = A @ W[:, n0 ..) for the
// warpgroup's 64 rows: three products a k-step (small terms first).
template <int G, int F, int N>
__device__ __forceinline__ void contract_chunk(const uint32_t (&ah)[FusedShape<G, F>::kSteps][4],
                                               const uint32_t (&al)[FusedShape<G, F>::kSteps][4],
                                               uint32_t w_hi, uint32_t w_lo, int ngs, int n0,
                                               float* __restrict__ out, int64_t out_stride,
                                               int64_t row0, int64_t rows, int lane) {
  using S = FusedShape<G, F>;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  groot::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < S::kSteps; ++ks) {
    const uint32_t off = static_cast<uint32_t>(ks * ngs + n0 / 8) * 2 * kCoreLbo;
    const uint64_t bh = groot::smem_desc(w_hi + off, kCoreLbo, kCoreSbo, groot::kSwizzleNone);
    const uint64_t bl = groot::smem_desc(w_lo + off, kCoreLbo, kCoreSbo, groot::kSwizzleNone);
    WgmmaTf32<N>::rs(d, al[ks], bh);
    WgmmaTf32<N>::rs(d, ah[ks], bl);
    WgmmaTf32<N>::rs(d, ah[ks], bh);
  }
  groot::wgmma_commit();
  groot::wgmma_wait<0>();
  groot::fence_regs(d);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row0 + gid + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(out + row * out_stride + n0 + 8 * j + 2 * tig) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// One block is one warpgroup; it walks 64-row tiles (warp w aggregating rows
// 16w .. 16w + 15 through its own ring), then the four warps contract the
// tile together, hp columns in 32-column chunks (output rows out_stride
// floats apart, 8-byte aligned).  K3: kWeighted, !kRound (fmaf of the
// widened weight and message); K7: G = 1, kRound (the product rounded to
// T), or !kWeighted (the message alone).
template <typename T, int G, int F, bool kWeighted, bool kRound>
__global__ void __launch_bounds__(kStagedWarps * kWarp, 2)
fused_staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                    const T* __restrict__ wg, const float* __restrict__ w,
                    float* __restrict__ out, int64_t out_stride, int64_t rows, int ld2,
                    int64_t w_gstride, int hp) {
  using S = FusedShape<G, F>;
  using Ring = groot::Ring<T, G>;
  extern __shared__ __align__(1024) unsigned char staged_smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int gid = lane >> 2, tig = lane & 3;
  const int ngs = hp / 8;
  const size_t w_bytes = static_cast<size_t>(S::kSteps) * ngs * 256;
  float* w_hi = reinterpret_cast<float*>(staged_smem);
  float* w_lo = reinterpret_cast<float*>(staged_smem + w_bytes);
  Ring& ring = reinterpret_cast<Ring*>(staged_smem + 2 * w_bytes)[warp];
  stage_w<G, F>(w_hi, w_lo, w, w_gstride, hp);
  __syncthreads();

  // every warp of the warpgroup walks the same number of 64-row tiles
  const groot::Walk walk(rows, ld2, 4 * static_cast<int64_t>(blockIdx.x) + warp,
                         4 * static_cast<int64_t>(gridDim.x),
                         groot::walk_steps(rows, 4, blockIdx.x, gridDim.x));
  // tile row r is read by the lanes of gid r % 8 (both of a lane's rows)
  const auto key = [ld2](int, int t) { return (t >> ld2) & 7; };
  const uint32_t hi_addr = groot::smem_u32(w_hi), lo_addr = groot::smem_u32(w_lo);

  float agg[2][S::kEntries];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < S::kEntries; ++e) agg[h][e] = 0.f;

  groot::run_walk<T, F, kWeighted>(ring, walk, cols, wg, x, lane, key,
                                   [&](const groot::Chunk& c, const unsigned char* staged,
                                       const T* ws) {
    // aggregate over this chunk's slots of rows gid, gid + 8, ascending
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      const int lo = max(r << ld2, c.begin) - c.begin;
      const int hi = min((r + 1) << ld2, c.begin + c.n) - c.begin;
      for (int p = lo; p < hi; ++p) {
        T xv[S::kFeat];
        groot::load_line(xv, staged + p * groot::kLine,
                         tig * S::kFeat * static_cast<int>(sizeof(T)), gid);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const T wv = kWeighted ? ws[p * G + g] : groot::zero<T>();
#pragma unroll
          for (int i = 0; i < S::kFeat; ++i)
            agg[h][g * S::kFeat + i] = groot::accumulate<kWeighted, kRound>(
                agg[h][g * S::kFeat + i], xv[i], wv);
        }
      }
    }
  }, [&](int64_t tile) {
    // the A fragments, split into TF32 high and low parts
    uint32_t ah[S::kSteps][4], al[S::kSteps][4];
#pragma unroll
    for (int ks = 0; ks < S::kSteps; ++ks) {
      constexpr int kE = S::kEntries;
      const int e0 = 2 * ks, e1 = 2 * ks + 1;
      const float av[4] = {agg[0][e0], agg[1][e0], e1 < kE ? agg[0][e1 < kE ? e1 : 0] : 0.f,
                           e1 < kE ? agg[1][e1 < kE ? e1 : 0] : 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) groot::split_tf32(av[j], ah[ks][j], al[ks][j]);
    }
    const int64_t row0 = tile * groot::kTile;
    for (int n0 = 0; n0 < hp; n0 += kChunkN)
      contract_chunk<G, F, kChunkN>(ah, al, hi_addr, lo_addr, ngs, n0, out, out_stride, row0,
                                    rows, lane);
    // the A fragments stay live until the products that read them completed
    groot::fence_regs(ah);
    groot::fence_regs(al);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < S::kEntries; ++e) agg[h][e] = 0.f;
  });
}

template <typename T, int G, int F>
size_t fused_smem_bytes(int hp) {
  return 2 * static_cast<size_t>(FusedShape<G, F>::kSteps) * (hp / 8) * 256 +
         kStagedWarps * sizeof(groot::Ring<T, G>);
}

// One launch's arguments (see fused_ld_staged below).
struct FusedArgs {
  const void* x;
  const void* cols;
  const void* wg;  // null: no weights
  const void* w;
  void* out;
  int64_t out_stride;
  int64_t rows;
  int ld2;
  int64_t w_gstride;
  int hp;
};

template <typename T, int G, int F, bool kWeighted, bool kRound>
int launch_staged(const FusedArgs& a, size_t* smem_only, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes<T, G, F>(a.hp);
  if (smem_only) {
    *smem_only = smem;
    return 0;
  }
  auto kernel = fused_staged_kernel<T, G, F, kWeighted, kRound>;
  dim3 grid;
  const int64_t tiles = (a.rows + 4 * groot::kTile - 1) / (4 * groot::kTile);  // 64-row tiles
  const cudaError_t err = groot::persistent_grid(kernel, kStagedWarps * kWarp, smem, tiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kStagedWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.cols),
      static_cast<const T*>(a.wg), static_cast<const float*>(a.w), static_cast<float*>(a.out),
      a.out_stride, a.rows, a.ld2, a.w_gstride, a.hp);
  return static_cast<int>(cudaGetLastError());
}

// mode 0: K3 (weights widened, fmaf); 1: K7 with a weight (product rounded
// to T); 2: K7 without weights.  K7 runs at one group only.
template <typename T, int G, int F>
int dispatch_mode(int mode, const FusedArgs& a, size_t* smem_only, cudaStream_t stream) {
  if constexpr (G == 1) {
    if (mode == 1) return launch_staged<T, 1, F, true, true>(a, smem_only, stream);
    if (mode == 2) return launch_staged<T, 1, F, false, true>(a, smem_only, stream);
  }
  if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_staged<T, G, F, true, false>(a, smem_only, stream);
}

template <typename T, int G>
int dispatch_feat(int feat, int mode, const FusedArgs& a, size_t* smem_only,
                  cudaStream_t stream) {
  switch (feat) {
    case 4: return dispatch_mode<T, G, 4>(mode, a, smem_only, stream);
    case 8: return dispatch_mode<T, G, 8>(mode, a, smem_only, stream);
    case 16: return dispatch_mode<T, G, 16>(mode, a, smem_only, stream);
    case 32: return dispatch_mode<T, G, 32>(mode, a, smem_only, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int groups, int feat, int mode, const FusedArgs& a, size_t* smem_only,
             cudaStream_t stream) {
  switch (groups) {
    case 1: return dispatch_feat<T, 1>(feat, mode, a, smem_only, stream);
    case 2: return dispatch_feat<T, 2>(feat, mode, a, smem_only, stream);
    case 3: return dispatch_feat<T, 3>(feat, mode, a, smem_only, stream);
    case 4: return dispatch_feat<T, 4>(feat, mode, a, smem_only, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int staged_call(int groups, int feat, int mode, int deg, int bf16, const FusedArgs& a,
                size_t* smem_only, cudaStream_t stream) {
  if (deg < 1 || (deg & (deg - 1)) || a.hp < kChunkN || a.hp % kChunkN)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch<__nv_bfloat16>(groups, feat, mode, a, smem_only, stream)
              : dispatch<float>(groups, feat, mode, a, smem_only, stream);
}

}  // namespace

// K3 (mode 0, wg of ``groups`` weights a slot) and K7 (groups 1; mode 1 with
// a weight, 2 without: wg null) over one ELL bucket and one slice of x:
// feat is the slice's staged width (4, 8, 16 or 32); w is that slice of the
// (G, ., hp) f32 weight stack, groups w_gstride floats apart, rows hp floats
// (hp a multiple of 32); out gets all hp columns, rows out_stride floats
// apart.
extern "C" int fused_ld_staged(const void* x, const void* cols, const void* wg, const void* w,
                               void* out, int64_t rows, int deg, int groups, int feat,
                               int64_t w_gstride, int hp, int64_t out_stride, int mode,
                               int bf16, void* stream) {
  if (rows <= 0) return 0;
  const FusedArgs a{x, cols, wg, w, out, out_stride, rows,
                    deg > 0 ? __builtin_ctz(static_cast<unsigned>(deg)) : 0, w_gstride, hp};
  return staged_call(groups, feat, mode, deg, bf16, a, nullptr, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block at this shape (-1: not a shape the body takes).
extern "C" int fused_ld_staged_smem(int groups, int feat, int hp, int mode, int bf16) {
  size_t smem = 0;
  const FusedArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, hp};
  const int rc = staged_call(groups, feat, mode, 1, bf16, a, &smem, nullptr);
  return rc ? -1 : static_cast<int>(smem);
}
