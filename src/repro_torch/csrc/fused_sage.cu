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
//
// Bound on the H100: memory.  Per destination row K3 reads d rows of x, d*G
// weights and d indices and writes H f32 outputs, for d*G*F aggregation
// multiply-adds (f32, 67 TFLOP/s) and G*F*H contraction multiply-adds (on
// the tensor cores as three TF32 products, so at 495/3 TFLOP/s).  At the
// model's width (F = H = 32, G = 4, d = 2) the least bytes (the distinct x
// rows touched, the staged weights, the indices and the (R, H) f32 output,
// each moved once, at 3.35 TB/s) take about twice as long as those
// operations.  What binds in practice is the contraction: as an f32 FMA
// loop that reads two shared-memory operands per multiply-add it takes 7x
// the bound, and as mma.sync m16n8k8 (one B fragment load from shared
// memory per 16 rows) it is still slower than the wgmma contraction below
// (PERF.md).
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
//    64 rows.  H runs in 32-column chunks plus a tail of H % 32 (a template
//    argument, so no wgmma sits under a runtime branch).  What the split
//    drops is under 2 * 2^-21 of each product.
//  * K = G*F is padded with zero columns to a multiple of 8 (G = 1 or 3 at
//    F = 4); rows past the bucket's end aggregate nothing and are not
//    stored.
// K7 keeps that first design (fused_kernel below): one warp per row, its
// (F) aggregate parked in shared memory and contracted by an f32 FMA loop
// against the weights, which every block loads into shared memory once.
// Accumulation is f32 for f32 and bf16 streams alike.  All offsets are int64.
#include "mma.cuh"
#include "staged.cuh"

namespace {

using groot::kWarp;

constexpr int kFusedWarps = 8;      // K7: rows in flight per block (one per warp)
constexpr int kBlocksPerSm = 8;     // K7: grid = SMs * this, rows strided over it
constexpr int kStagedWarps = 4;     // K3: one warpgroup a block, each warp its own ring

// --- K3: staged gather, contraction by wgmma ----------------------------------

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
struct WgmmaTf32<8> {
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : WG_D4(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaTf32<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : WG_D4(d, 0), WG_D4(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaTf32<24> {
  static __device__ __forceinline__ void rs(float (&d)[12], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : WG_D4(d, 0), WG_D4(d, 4), WG_D4(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

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

// W's TF32 high and low parts, each as the K-major B operand (W^T, H rows of
// K) in 8-row x 16-byte core matrices: core matrix (ks, ng, kc) holds
// columns 8 ng .. 8 ng + 7 of W at the four K positions 4 kc .. 4 kc + 3 of
// k-step ks, at ((ks * NG + ng) * 2 + kc) * 128 bytes: K neighbours 128 bytes
// apart (LBO), 8-column groups 256 (SBO).
constexpr uint32_t kCoreLbo = 128, kCoreSbo = 256;

template <int G, int F>
__device__ void stage_w(float* __restrict__ w_hi, float* __restrict__ w_lo,
                        const float* __restrict__ w_stack, int hid) {
  using S = FusedShape<G, F>;
  const int ngs = hid / 8;
  const int total = S::kSteps * ngs * 64;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int t = i & 3, r = (i >> 2) & 7, kc = (i >> 5) & 1;
    const int ng = (i >> 6) % ngs, ks = (i >> 6) / ngs;
    const int e = 2 * ks + kc, g = e / S::kFeat, f = t * S::kFeat + e % S::kFeat;
    const float v = g < G ? w_stack[(static_cast<int64_t>(g) * F + f) * hid + ng * 8 + r] : 0.f;
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
                                               float* __restrict__ out, int64_t row0,
                                               int64_t rows, int hid, int lane) {
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
      *reinterpret_cast<float2*>(out + row * hid + n0 + 8 * j + 2 * tig) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// One block is one warpgroup; it walks 64-row tiles (warp w aggregating rows
// 16w .. 16w + 15 through its own ring), then the four warps contract the
// tile together.  kTail = H % 32: H is contracted in 32-column chunks and a
// tail of kTail columns.
template <typename T, int G, int F, int kTail>
__global__ void __launch_bounds__(kStagedWarps * kWarp, 2)
fused_staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                    const T* __restrict__ wg, const float* __restrict__ w_stack,
                    float* __restrict__ out, int64_t rows, int ld2, int hid) {
  using S = FusedShape<G, F>;
  using Ring = groot::Ring<T, G>;
  extern __shared__ __align__(1024) unsigned char staged_smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int gid = lane >> 2, tig = lane & 3;
  const int ngs = hid / 8;
  const size_t w_bytes = static_cast<size_t>(S::kSteps) * ngs * 256;
  float* w_hi = reinterpret_cast<float*>(staged_smem);
  float* w_lo = reinterpret_cast<float*>(staged_smem + w_bytes);
  Ring& ring = reinterpret_cast<Ring*>(staged_smem + 2 * w_bytes)[warp];
  stage_w<G, F>(w_hi, w_lo, w_stack, hid);
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

  groot::run_walk<T, F>(ring, walk, cols, wg, x, lane, key, [&](const groot::Chunk& c,
                                                               const unsigned char* staged,
                                                               const T* ws) {
    // aggregate: fmaf(w, x, acc) over this chunk's slots of rows gid, gid + 8
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
          const float w = groot::to_f32(ws[p * G + g]);
#pragma unroll
          for (int i = 0; i < S::kFeat; ++i)
            agg[h][g * S::kFeat + i] = fmaf(w, groot::to_f32(xv[i]), agg[h][g * S::kFeat + i]);
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
    int n0 = 0;
    for (; n0 + 32 <= hid; n0 += 32)
      contract_chunk<G, F, 32>(ah, al, hi_addr, lo_addr, ngs, n0, out, row0, rows, hid, lane);
    if constexpr (kTail > 0)
      contract_chunk<G, F, kTail>(ah, al, hi_addr, lo_addr, ngs, n0, out, row0, rows, hid, lane);
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
size_t fused_smem_bytes(int hid) {
  return 2 * static_cast<size_t>(FusedShape<G, F>::kSteps) * (hid / 8) * 256 +
         kStagedWarps * sizeof(groot::Ring<T, G>);
}

template <typename T, int G, int F, int kTail>
int launch_staged(const void* x, const void* cols, const void* wg, const void* w_stack,
                  void* out, int64_t rows, int ld2, int hid, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes<T, G, F>(hid);
  auto kernel = fused_staged_kernel<T, G, F, kTail>;
  dim3 grid;
  const int64_t tiles = (rows + 4 * groot::kTile - 1) / (4 * groot::kTile);  // 64-row tiles
  const cudaError_t err = groot::persistent_grid(kernel, kStagedWarps * kWarp, smem, tiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kStagedWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cols), static_cast<const T*>(wg),
      static_cast<const float*>(w_stack), static_cast<float*>(out), rows, ld2, hid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int F>
int dispatch_tail(const void* x, const void* cols, const void* wg, const void* w_stack,
                  void* out, int64_t rows, int ld2, int hid, size_t* smem_only,
                  cudaStream_t stream) {
  if (smem_only) {
    *smem_only = fused_smem_bytes<T, G, F>(hid);
    return 0;
  }
  switch (hid % 32) {
    case 0: return launch_staged<T, G, F, 0>(x, cols, wg, w_stack, out, rows, ld2, hid, stream);
    case 8: return launch_staged<T, G, F, 8>(x, cols, wg, w_stack, out, rows, ld2, hid, stream);
    case 16: return launch_staged<T, G, F, 16>(x, cols, wg, w_stack, out, rows, ld2, hid, stream);
    default: return launch_staged<T, G, F, 24>(x, cols, wg, w_stack, out, rows, ld2, hid, stream);
  }
}

template <typename T, int G>
int dispatch_feat(int feat, const void* x, const void* cols, const void* wg,
                  const void* w_stack, void* out, int64_t rows, int ld2, int hid,
                  size_t* smem_only, cudaStream_t stream) {
  switch (feat) {
    case 4: return dispatch_tail<T, G, 4>(x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 8: return dispatch_tail<T, G, 8>(x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 16: return dispatch_tail<T, G, 16>(x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 32: return dispatch_tail<T, G, 32>(x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int groups, int feat, const void* x, const void* cols, const void* wg,
             const void* w_stack, void* out, int64_t rows, int ld2, int hid, size_t* smem_only,
             cudaStream_t stream) {
  switch (groups) {
    case 1: return dispatch_feat<T, 1>(feat, x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 2: return dispatch_feat<T, 2>(feat, x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 3: return dispatch_feat<T, 3>(feat, x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    case 4: return dispatch_feat<T, 4>(feat, x, cols, wg, w_stack, out, rows, ld2, hid, smem_only, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int staged_call(const void* x, const void* cols, const void* wg, const void* w_stack, void* out,
                int64_t rows, int deg, int groups, int feat, int hid, int bf16,
                size_t* smem_only, cudaStream_t stream) {
  if (deg < 1 || (deg & (deg - 1)) || hid < 8 || hid % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld2 = __builtin_ctz(static_cast<unsigned>(deg));
  return bf16 ? dispatch<__nv_bfloat16>(groups, feat, x, cols, wg, w_stack, out, rows, ld2, hid,
                                        smem_only, stream)
              : dispatch<float>(groups, feat, x, cols, wg, w_stack, out, rows, ld2, hid,
                                smem_only, stream);
}

// --- K7: one warp per row, f32 FMA contraction --------------------------------

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
  return staged_call(x, cols, wg, w_stack, out, rows, deg, groups, feat, hid, bf16, nullptr,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one K3 block at this shape (-1: not a shape K3 takes).
extern "C" int fused_ld_grouped_smem(int groups, int feat, int hid, int bf16) {
  size_t smem = 0;
  const int rc = staged_call(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, groups, feat,
                             hid, bf16, &smem, nullptr);
  return rc ? -1 : static_cast<int>(smem);
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
