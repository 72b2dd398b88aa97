// Flash attention for Hopper (sm_90a), plain C interface.
//
// K8 flash_attention replaces the Pallas kernel
//    src/repro/kernels/flash_attention.py:_flash_kernel (launched by
//    flash_attention): online-softmax attention over q (BH, S, hd) and k/v
//    (BH / G, T, hd), causal, sliding-window or bidirectional, with an
//    optional logit softcap.  Row r of query head bh reads KV row bh / G.
//    Per key tile, as the Pallas kernel computes it:
//        s = (q k^T) * scale in f32;  s = softcap * tanh(s / softcap);
//        s = ok ? s : -1e30;  m' = max(m, rowmax s);  a = exp(m - m');
//        p = exp(s - m');  l = l * a + rowsum p;  acc = acc * a + p_T v
//    with p_T the probabilities rounded to the stream dtype, and at the end
//    out = acc / max(l, 1e-30) in the stream dtype.
//
// Bound on the H100: tensor-core operations.  qwen3-8b prefill (B = 4, 32
// query heads over 8 KV heads, S = T = 4096, hd = 128, causal) needs
// 4 * BH * hd * (attended pairs) = 0.55 TFLOP, 0.556 ms at 989 TFLOP/s bf16,
// against 0.34 GB of q, k, v and o, 0.10 ms at 3.35 TB/s: about 1,600
// operations per byte.  Only at a few hundred tokens do the bytes bind.
//
// Two bodies; the wrapper names which one a (dtype, hd) takes
// (kernels/flash_attention.py BODIES) and the entry point refuses any other.
//
// The wgmma body (bf16 at hd 64, 128 and 256) is built to reach that bound:
//  * wgmma: both products run as warpgroup MMAs, the only instruction that
//    reaches the card's full bf16 rate.  S = Q K^T is m64n{kBN}k16 with both
//    operands in shared memory; O += P V is m64n{hd}k16 with P the A operand
//    in registers (the S accumulator's fragment, rounded to bf16 to nearest,
//    is exactly the A fragment, so p never touches shared memory) and V the
//    B operand in shared memory, MN-major (no transposing copy of V).
//  * One block of three warpgroups per (bh, 128-row query tile).  Warpgroup 0
//    is the producer: one thread issues every TMA load and the group gives
//    its registers up (setmaxnreg.dec).  Warpgroups 1 and 2 each own 64 query
//    rows, take the registers (setmaxnreg.inc) and keep m, l and the f32 O
//    accumulator in them for the whole loop.  Each K/V tile is reused by 128
//    query rows.
//  * A ring of kStages K/V stages in shared memory, with a "full" mbarrier
//    per K and per V tile (TMA completes its bytes on it) and an "empty" one
//    per K and per V slot (each consumer warp arrives once the product that
//    read it has completed).  The next tiles load while the current one is
//    computed.
//  * The consumers take turns: step i issues S_i = Q K_i^T together with
//    O += P_{i-1} V_{i-1}, and two named barriers let one warpgroup issue
//    only after the other has, so one's softmax runs while the other's
//    products hold the tensor cores (left alone, both reach the softmax at
//    once and the tensor cores idle).  The first step (no P V yet) and the
//    last (P V only) are peeled off the loop: a wgmma under a condition
//    makes ptxas serialise every wgmma of the kernel.
//  * TMA with 3-D tensor maps over (hd, rows, heads), 128-byte swizzle (the
//    layout wgmma reads without bank conflicts), so a 128-wide bf16 row
//    loads as two 64-element boxes.  Rows past S or T are zero-filled on
//    load and clipped on store by the hardware: no tile reads into another
//    head's rows.  The output leaves through the block's own query slab,
//    swizzled the same way, by a TMA store.
//  * Tiles: 128 keys (64 at hd = 256, where O alone takes 128 registers a
//    thread).  Shared memory: Q (128 x hd) plus kStages x (K + V), 160 KB at
//    hd = 128 and 192 KB at hd = 256 of the 227 KB a block may use.
//  * Positions come from tile indices (no mask tensor).  Key tiles wholly
//    outside the causal/window band of the block's rows are skipped: once a
//    row has seen a valid key a fully masked tile adds exactly 0 (a = 1,
//    p = 0), and one seen before that is wiped by a = exp(-1e30 - m) = 0, so
//    the result is the Pallas kernel's.  Only tiles that straddle the
//    diagonal, the window edge or T build a mask.  Keys are walked in
//    ascending order, as the Pallas kernel and the plain version walk them,
//    so p is rounded against the same running maxima.  Causal blocks are
//    dispatched heaviest first: the query-tile index is reversed along the
//    slower grid axis, heads along the faster.
//  * Numerics at the Pallas kernel's rounding points: f32 scores, tanhf for
//    the softcap, the finite -1e30 sentinel, row max and sum across the 4
//    lanes of a quad.  exp(x) runs as 2^(x log2 e) with log2(e) folded into
//    the scale, one MUFU ex2 an element: the softmax's instruction count,
//    not the tensor cores, sets the pace here, and the share of outputs that
//    differ from the plain version's (accurate exp) stays where accurate
//    expf put it.
//
// The mma.sync body (f32 streams) keeps f32 scores on the tensor cores: one
// block of 4 warps per (bh, 64-row query tile) loops over 64-key tiles; each
// product runs as three m16n8k8 TF32 MMAs (high x high, high x residual,
// residual x high; what the split drops is under 2 * 2^-21 of each product).
// The tiles are staged by 16-byte loads, p goes through shared memory (row
// strides padded by 16 bytes), and the query tiles run in reverse for causal
// calls.  Shared memory: 217 KB at hd = 256.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kBM = kWarps * 16;  // query rows per block (16 per warp)
constexpr int kBN = 64;           // keys per step
constexpr float kNegInf = -1e30f;

// mma.sync fragments as in mma.cuh.  Every load reads shared memory at a
// tile's origin with row stride ld.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  static constexpr int kPad = 4;  // elements: 16 bytes
  // each f32 operand as a TF32 high part and a TF32 residual
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ void split(uint32_t& hi, uint32_t& lo, float x) {
    groot::split_tf32(x, hi, lo);
  }
  // A (16 x 8), row-major: a0 (gid, tig) a1 (gid + 8, tig) a2 (gid, tig + 4) a3 (gid + 8, tig + 4)
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int gid, int tig) {
    split(a.hi[0], a.lo[0], s[gid * ld + tig]);
    split(a.hi[1], a.lo[1], s[(gid + 8) * ld + tig]);
    split(a.hi[2], a.lo[2], s[gid * ld + tig + 4]);
    split(a.hi[3], a.lo[3], s[(gid + 8) * ld + tig + 4]);
  }
  // B (8 x 8): b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
  static __device__ __forceinline__ void load_b_nk(B& b, const T* s, int ld, int gid, int tig) {
    split(b.hi[0], b.lo[0], s[gid * ld + tig]);
    split(b.hi[1], b.lo[1], s[gid * ld + tig + 4]);
  }
  static __device__ __forceinline__ void load_b_kn(B& b, const T* s, int ld, int gid, int tig) {
    split(b.hi[0], b.lo[0], s[tig * ld + gid]);
    split(b.hi[1], b.lo[1], s[(tig + 4) * ld + gid]);
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    groot::mma_tf32(c, a, b[0], b[1]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);  // small terms first
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ void store_pair(T* s, float x0, float x1) {
    *reinterpret_cast<float2*>(s) = make_float2(x0, x1);
  }
};

__device__ __forceinline__ void store_out(float* o, float x0, float x1) {
  *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
}

// Rows [0, valid) of a (kRows, HD) tile from global memory (rows of HD
// contiguous elements) into shared memory with row stride ld; rows past
// valid are zero.
template <typename T, int HD, int kRows>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int valid,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBM + 2 * kBN) * (HD + Mma<T>::kPad) +
          static_cast<size_t>(kBM) * (kBN + Mma<T>::kPad)) * sizeof(T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int s, int t, int group, int causal, int window, float scale,
             float softcap) {
  using M = Mma<T>;
  constexpr int kLd = HD + M::kPad;
  constexpr int kLdP = kBN + M::kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBM * kLd;
  T* vs = ks + kBN * kLd;
  T* ps = vs + kBN * kLd;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_q = (s + kBM - 1) / kBM;
  const int q0 = (causal ? n_q - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kBM;
  const int64_t bh = blockIdx.y;
  const T* kg = k + (bh / group) * t * HD;
  const T* vg = v + (bh / group) * t * HD;
  load_tile<T, HD, kBM>(qs, kLd, q + (bh * s + q0) * HD, min(kBM, s - q0), tid);

  // key tiles that hold a valid key for some row of this block
  const int q_last = min(q0 + kBM, s) - 1;
  const int k_end = causal ? min(t, q_last + 1) : t;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int kt_end = (k_end + kBN - 1) / kBN;

  const int row0 = q0 + warp * 16 + gid;  // this lane's rows: row0 and row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const T* qw = qs + warp * 16 * kLd;
  T* pw = ps + warp * 16 * kLdP;

  for (int kt = k_begin / kBN; kt < kt_end; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the last tile's K/V reads are done (and the Q tile is in)
    load_tile<T, HD, kBN>(ks, kLd, kg + static_cast<int64_t>(k0) * HD, min(kBN, t - k0), tid);
    load_tile<T, HD, kBN>(vs, kLd, vg + static_cast<int64_t>(k0) * HD, min(kBN, t - k0), tid);
    __syncthreads();

    // scores: this warp's (16, kBN) tile of q k^T
    float sc[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD; kk += M::kK) {
      typename M::A a;
      M::load_a(a, qw + kk, kLd, gid, tig);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        typename M::B b;
        M::load_b_nk(b, ks + nt * 8 * kLd + kk, kLd, gid, tig);
        M::mma(sc[nt], a, b);
      }
    }

    // scale, softcap, mask; the online softmax of the two rows
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + nt * 8 + 2 * tig + (e & 1);
        float x = sc[nt][e] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = col < t && (!causal || col <= row) && (window == 0 || col > row - window);
        x = ok ? x : kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e >> 1]);
        sum[e >> 1] += p;
        sc[nt][e] = p;
      }
      M::store_pair(pw + gid * kLdP + nt * 8 + 2 * tig, sc[nt][0], sc[nt][1]);
      M::store_pair(pw + (gid + 8) * kLdP + nt * 8 + 2 * tig, sc[nt][2], sc[nt][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    __syncwarp();  // this warp's p tile is in shared memory

    // acc += p_T v
#pragma unroll
    for (int kk = 0; kk < kBN; kk += M::kK) {
      typename M::A a;
      M::load_a(a, pw + kk, kLdP, gid, tig);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        typename M::B b;
        M::load_b_kn(b, vs + kk * kLd + nt * 8, kLd, gid, tig);
        M::mma(acc[nt], a, b);
      }
    }
    __syncwarp();  // p reads done before the next tile overwrites it
  }

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    T* orow = o + (bh * s + row) * HD + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      store_out(orow + nt * 8, acc[nt][2 * r] / den[r], acc[nt][2 * r + 1] / den[r]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh, int s, int t,
           int group, int causal, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBM - 1) / kBM, static_cast<unsigned>(bh));
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, group, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wgmma body: bf16, TMA-fed K/V ring, producer and consumer warpgroups.
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kBM = 128;                  // query rows per block, 64 per consumer
constexpr int kRow = 128;                 // bytes per row of a 64-wide bf16 panel
constexpr int kStages = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 40 * 128 + 232 * 256 <= 65,536

// A tile of R rows x HD bf16 lives as HD / 64 column panels of R x 128 bytes,
// each in TMA's 128-byte swizzle: 16-byte chunk c of row r sits at chunk
// c ^ (r % 8), and every panel starts on a 1,024-byte boundary.
template <int HD>
struct Cfg {
  static constexpr int kBN = HD == 256 ? 64 : 128;  // keys per tile
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarrierBytes = 8 * (1 + 4 * kStages);
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes + kBarrierBytes;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; its bytes complete on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory operand in the 128-byte swizzle (groot::smem_desc).
// K-major (Q, K): rows 128 bytes apart, 8-row groups 1,024 apart (SBO), the
// leading offset unused; a k16 step moves the start 32 bytes along the row.
// MN-major (V): 8-row groups along k 1,024 apart (SBO), 64-column panels
// along n LBO apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return groot::smem_desc(addr, lbo, sbo, groot::kSwizzle128);
}

// Named barriers between the two consumer warpgroups (256 threads): one
// waits for its turn, the other hands it over.
constexpr int kTurn = 3;  // kTurn + warpgroup; 1 and 2 are the epilogue's
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16.  ss (S = Q K^T, N = the key tile): A
// (64 x 16) and B (16 x N) both K-major in shared memory, scale_d == 0 drops
// D's old value.  rs (O += P V, N = hd): A from registers, B MN-major in
// shared memory.  D fragment: thread 4 * g + q of warp w holds d[4j + e] at
// row 16w + g + 8(e / 2), column 8j + 2q + e % 2; the A fragment of a k16
// step is the same layout over its 16 columns.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_D64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {  // O at hd = 256 only
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WG_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef WG_D4
#undef WG_D16
#undef WG_D32
#undef WG_D64
#undef WG_D128

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU operation (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Scale, softcap and (kMask) mask one S tile held as the D fragment, then the
// online softmax of this thread's two rows: sc becomes p (f32), m and l move
// on, alpha is the factor for the old accumulator.  Scores and m are kept in
// units of log2(e) (exp(x) = 2^(x log2 e)): scale2 = scale * log2(e), and
// with a softcap the capped score is multiplied by log2(e) once it is capped.
template <bool kMask, int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row0, int k0, int tig, int t,
                                             int causal, int window, float scale, float scale2,
                                             float softcap) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if (softcap != 0.f) {
        x = softcap * tanhf(sc[4 * j + e] * scale / softcap) * kLog2e;
      } else {
        x = sc[4 * j + e] * scale2;
      }
      if (kMask) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * tig + (e & 1);
        const bool ok = col < t && (!causal || col <= row) && (window == 0 || col > row - window);
        x = ok ? x : kNegInf;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = ex2(sc[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   int s, int t, int group, int causal, int window, float scale, float softcap) {
  using C = Cfg<HD>;
  constexpr int BN = C::kBN;
  constexpr int kPanels = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sq = groot::smem_u32(smem);           // Q panels (kBM rows each)
  const uint32_t skv = sq + C::kQBytes;          // stage st: K, then V
  const uint32_t bar = skv + kStages * C::kStageBytes;
  // q_full, then per stage: K full, V full, K empty, V empty
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bar + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bar + 8 * (1 + 3 * kStages + st); };

  const int n_q = (s + kBM - 1) / kBM;
  const int qt = causal ? n_q - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBM;
  const int bh = blockIdx.x;
  // key tiles that hold a valid key for some row of this block
  const int q_last = min(q0 + kBM, s) - 1;
  const int k_end = causal ? min(t, q_last + 1) : t;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BN, kt_end = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 2 * 4);  // every consumer warp
      mbar_init(v_empty(st), 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // -- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = bh / group;
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < kPanels; ++p)
        for (int h = 0; h < 2; ++h)
          tma_load(sq + p * kBM * kRow + h * 64 * kRow, &tq, q_full, 64 * p, q0 + 64 * h, bh);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const uint32_t kb = skv + st * C::kStageBytes, vb = kb + C::kTileBytes;
        mbar_wait(k_empty(st), phase ^ 1);
        mbar_expect_tx(k_full(st), C::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(kb + p * BN * kRow, &tk, k_full(st), 64 * p, kt * BN, kvh);
        mbar_wait(v_empty(st), phase ^ 1);
        mbar_expect_tx(v_full(st), C::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(vb + p * BN * kRow, &tv, v_full(st), 64 * p, kt * BN, kvh);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int ctid = threadIdx.x - wg * kWgThreads;
    const int warp = ctid / kWarp, lane = ctid % kWarp;
    const int gid = lane >> 2, tig = lane & 3;
    const int rw0 = q0 + 64 * cw;             // this warpgroup's first row
    const int row0 = rw0 + 16 * warp + gid;   // this thread's rows: row0 and row0 + 8
    const uint32_t qa = sq + cw * 64 * kRow;  // its 64 rows in each Q panel

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[HD / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    mbar_wait(q_full, 0);

    const float scale2 = scale * kLog2e;
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[ks][e] = 0u;
    // Step i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} together, waits for
    // both, then runs the softmax of S_i and rescales O by its alpha, so the
    // sums are the sequential acc = acc * a + p_T v of every tile.  The two
    // consumer warpgroups take turns to issue (named barriers kTurn + cw):
    // one's softmax runs while the other's products hold the tensor cores.
    // K and V stages are released as soon as their product has completed.
    // The first step (no P V yet) and the last (P V only) are peeled off, so
    // no wgmma sits under a condition inside the loop.
    auto gemm_s = [&](int st) {
      const uint32_t kb = skv + st * C::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-wide panel
        Wgmma<BN>::ss(sc, desc(qa + (kk >> 2) * kBM * kRow + off, 16, 1024),
                      desc(kb + (kk >> 2) * BN * kRow + off, 16, 1024), kk > 0);
      }
    };
    auto gemm_pv = [&](int st) {
      const uint32_t vb = skv + st * C::kStageBytes + C::kTileBytes;
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks)
        Wgmma<HD>::rs(o, pa[ks], desc(vb + ks * 16 * kRow, BN * kRow, 1024));
    };
    auto fence_all = [&]() {
      groot::fence_regs(sc);
      groot::fence_regs(o);
      groot::fence_regs(pa);
    };
    // the online softmax of tile kt, O rescaled, P rounded to bf16; only tiles
    // past T or across the diagonal or the window edge of the block's rows
    // build a mask (decided for the whole block: both warpgroups branch alike)
    auto softmax = [&](int kt) {
      const int k0 = kt * BN;
      const bool mask = k0 + BN > t || (causal && k0 + BN - 1 > q0) ||
                        (window != 0 && k0 <= q0 + kBM - 1 - window);
      float alpha[2];
      if (mask) {
        softmax_tile<true, BN>(sc, m, l, alpha, row0, k0, tig, t, causal, window, scale, scale2,
                               softcap);
      } else {
        softmax_tile<false, BN>(sc, m, l, alpha, row0, k0, tig, t, causal, window, scale, scale2,
                                softcap);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[ks][e] = pack_rn(sc[8 * ks + 2 * e], sc[8 * ks + 2 * e + 1]);
    };

    if (kt_begin < kt_end) {
      if (cw == 1) turn_arrive(kTurn);  // warpgroup 1 lets 0 go first
      int st = 0;
      uint32_t phase = 0;
      mbar_wait(k_full(st), phase);
      turn_sync(kTurn + cw);
      fence_all();
      groot::wgmma_fence();
      gemm_s(st);
      groot::wgmma_commit();
      turn_arrive(kTurn + 1 - cw);
      groot::wgmma_wait<0>();
      fence_all();
      if (lane == 0) mbar_arrive(k_empty(st));
      softmax(kt_begin);
      for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
        const int pst = st;
        const uint32_t pphase = phase;
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
        mbar_wait(k_full(st), phase);
        mbar_wait(v_full(pst), pphase);
        turn_sync(kTurn + cw);
        fence_all();
        groot::wgmma_fence();
        gemm_s(st);
        gemm_pv(pst);
        groot::wgmma_commit();
        turn_arrive(kTurn + 1 - cw);
        groot::wgmma_wait<0>();
        fence_all();
        if (lane == 0) {
          mbar_arrive(k_empty(st));
          mbar_arrive(v_empty(pst));
        }
        softmax(kt);
      }
      mbar_wait(v_full(st), phase);  // the last tile's P V
      turn_sync(kTurn + cw);
      fence_all();
      groot::wgmma_fence();
      gemm_pv(st);
      groot::wgmma_commit();
      if (cw == 0) turn_arrive(kTurn + 1);  // balances warpgroup 1's first arrive
      groot::wgmma_wait<0>();
      fence_all();
      if (lane == 0) mbar_arrive(v_empty(st));
    }

    // out = acc / max(l, 1e-30) in bf16, into this warpgroup's Q slab (its
    // last S product has completed), swizzled as TMA reads it, then stored
    if (rw0 < s) {
      const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
      unsigned char* slab = smem + cw * 64 * kRow;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = 16 * warp + gid + 8 * r;
          const int chunk = (j & 7) ^ (rr & 7);
          *reinterpret_cast<uint32_t*>(slab + (j >> 3) * kBM * kRow + rr * kRow + chunk * 16 +
                                       4 * tig) =
              pack_rn(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, %1;" ::"r"(1 + cw), "n"(kWgThreads) : "memory");
      if (ctid == 0) {
        for (int p = 0; p < kPanels; ++p) tma_store(&to, qa + p * kBM * kRow, 64 * p, rw0, bh);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so that
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (heads, rows, hd) tensor as a 3-D map of (64, box_rows, 1) boxes in
// the 128-byte swizzle.  TMA needs a 16-byte aligned base and row and head
// strides that are multiples of 16 bytes: the wrapper checks the base, and
// hd * 2 and rows * hd * 2 bytes are multiples of 128 for hd in 64, 128, 256.
bool tensor_map(CUtensorMap* map, const void* base, int hd, int rows, int64_t heads,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh, int s, int t,
           int group, int causal, int window, float scale, float softcap, cudaStream_t stream) {
  using C = Cfg<HD>;
  static_assert(C::kSmem <= 232448, "shared memory over the 227 KB a block may use");
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, HD, s, bh, 64) || !tensor_map(&tk, k, HD, t, bh / group, C::kBN) ||
      !tensor_map(&tv, v, HD, t, bh / group, C::kBN) || !tensor_map(&to, o, HD, s, bh, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), (s + kBM - 1) / kBM);
  flash_wgmma_kernel<HD><<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, to, s, t, group,
                                                               causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper


template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o, int64_t bh, int s,
             int t, int group, int causal, int window, float scale, float softcap,
             cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_wgmma(int hd, const void* q, const void* k, const void* v, void* o, int64_t bh,
                   int s, int t, int group, int causal, int window, float scale, float softcap,
                   cudaStream_t stream) {
  switch (hd) {
    case 64: return hopper::launch<64>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    case 128: return hopper::launch<128>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    case 256: return hopper::launch<256>(q, k, v, o, bh, s, t, group, causal, window, scale, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, s, hd), k/v (bh / group, t, hd), o (bh, s, hd), all contiguous.
// body 0: the mma.sync body (f32); body 1: the wgmma body (bf16).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int64_t bh,
                               int s, int t, int hd, int group, int causal, int window,
                               float scale, float softcap, int bf16, int body, void* stream) {
  if (bh <= 0 || s <= 0 || t <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_wgmma(hd, q, k, v, o, bh, s, t, group, causal, window, scale, softcap, st);
  }
  if (body != 0 || bf16) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float>(hd, q, k, v, o, bh, s, t, group, causal, window, scale, softcap, st);
}

// Dynamic shared memory of one wgmma-body block at head dim hd (0 if none).
extern "C" int flash_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return static_cast<int>(hopper::Cfg<64>::kSmem);
    case 128: return static_cast<int>(hopper::Cfg<128>::kSmem);
    case 256: return static_cast<int>(hopper::Cfg<256>::kSmem);
    default: return 0;
  }
}
