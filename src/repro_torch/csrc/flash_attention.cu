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
// Bound on the H100: tensor-core operations at the serving shapes.  qwen3-8b
// prefill (B = 4, 32 query heads over 8 KV heads, S = T = 4096, hd = 128,
// causal) needs 4 * BH * hd * S * T / 2 = 0.55 TFLOP, 0.56 ms at 989 TFLOP/s
// bf16, against 0.34 GB of q, k, v and o, 0.10 ms at 3.35 TB/s: about 1,600
// operations per byte.  Only at a few hundred tokens do the bytes bind.
//
// What the design does about it:
//  * Blocks run in parallel: one block of 4 warps per (bh, 64-row query
//    tile).  A loop inside the block over the 64-key tiles replaces the
//    Pallas kv grid axis and its VMEM scratch: the running max m, the
//    denominator l and the (16, hd) f32 accumulator of each warp's 16 rows
//    stay in registers for the whole loop, and the (64, 64) score tile never
//    leaves the block.
//  * Both products run on the tensor cores with mma.sync.  bf16 streams: one
//    m16n8k16 bf16 MMA with f32 accumulators.  f32 streams: three m16n8k8
//    TF32 MMAs per product (high x high, high x residual, residual x high;
//    what the split drops is below 2^-21 of each product), so the scores stay
//    f32-accurate.
//  * The query tile and each K/V tile are staged in shared memory by 16-byte
//    loads; each warp writes its p tile, rounded to the stream dtype, to its
//    own slice of shared memory and reads it back as the A operand of p v.
//    Row strides are padded by 16 bytes so a fragment load hits 32 banks.
//  * Positions come from tile indices (no mask tensor), and the block masks
//    its own ragged S/T edge instead of padding.  Key tiles wholly outside
//    the causal/window band of the block's rows are skipped: once a row has
//    seen a valid key a fully masked tile adds exactly 0 (a = 1, p = 0), and
//    one seen before that is wiped by a = exp(-1e30 - m) = 0, so the result
//    is the Pallas kernel's.  Causal blocks start with the heaviest tiles.
//  * Shared memory: (64 + 2 * 64) rows of hd plus the p tiles, 61 KB for
//    bf16 at hd = 128, 217 KB for f32 at hd = 256 (of the 227 KB a block may
//    use).
// wgmma, TMA and a pipelined K/V ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kBM = kWarps * 16;  // query rows per block (16 per warp)
constexpr int kBN = 64;           // keys per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k16 /
// mma.m16n8k8"): lane = 4 * gid + tig; A rows gid and gid + 8; B column gid;
// C c0, c1 at (gid, 2 tig + {0, 1}) and c2, c3 at (gid + 8, 2 tig + {0, 1}).
// Every load reads shared memory at a tile's origin with row stride ld.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;  // elements: 16 bytes
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  // A (16 x 16), row-major
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int gid, int tig) {
    a.r[0] = ld32(s + gid * ld + 2 * tig);
    a.r[1] = ld32(s + (gid + 8) * ld + 2 * tig);
    a.r[2] = ld32(s + gid * ld + 2 * tig + 8);
    a.r[3] = ld32(s + (gid + 8) * ld + 2 * tig + 8);
  }
  // B (16 x 8) stored as s[n][k] (k contiguous: the K tile)
  static __device__ __forceinline__ void load_b_nk(B& b, const T* s, int ld, int gid, int tig) {
    b.r[0] = ld32(s + gid * ld + 2 * tig);
    b.r[1] = ld32(s + gid * ld + 2 * tig + 8);
  }
  // B (16 x 8) stored as s[k][n] (n contiguous: the V tile)
  static __device__ __forceinline__ void load_b_kn(B& b, const T* s, int ld, int gid, int tig) {
    b.r[0] = pack_bf16(s[(2 * tig) * ld + gid], s[(2 * tig + 1) * ld + gid]);
    b.r[1] = pack_bf16(s[(2 * tig + 8) * ld + gid], s[(2 * tig + 9) * ld + gid]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
  static __device__ __forceinline__ void store_pair(T* s, float x0, float x1) {
    *reinterpret_cast<uint32_t*>(s) = pack_bf16(__float2bfloat16_rn(x0), __float2bfloat16_rn(x1));
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  static constexpr int kPad = 4;  // elements: 16 bytes
  // each f32 operand as a TF32 high part and a TF32 residual
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ void split(uint32_t& hi, uint32_t& lo, float x) {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
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
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x0, float x1) {
  Mma<__nv_bfloat16>::store_pair(o, x0, x1);
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

}  // namespace

// q (bh, s, hd), k/v (bh / group, t, hd), o (bh, s, hd), all contiguous.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int64_t bh,
                               int s, int t, int hd, int group, int causal, int window,
                               float scale, float softcap, int bf16, void* stream) {
  if (bh <= 0 || s <= 0 || t <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, bh, s, t, group, causal, window, scale,
                                        softcap, st)
              : dispatch<float>(hd, q, k, v, o, bh, s, t, group, causal, window, scale, softcap,
                                st);
}
