// A warp's walk over the 16-row tiles of one ELL bucket, its gather staged
// through shared memory by cp.async (K3 and K7 fused_sage.cu; K4 and both
// K5 bodies groot_spmm.cu).
//
// A tile's 16 * d edge slots are cut into chunks of kChunk slots, and each
// warp walks the chunks of its tiles in order (tiles strided over every warp
// of the grid).  Per chunk, two copies run ahead of the arithmetic:
//  * meta: the chunk's column indices and its G weights a slot (none for a
//    stream without weights), straight from the bucket's contiguous slabs
//    (16-byte copies), two chunks ahead;
//  * rows: each slot's x row (F of T), gathered through its column index,
//    one chunk ahead (16-byte copies, or one 8-byte copy for an 8-byte row).
// So while a warp computes chunk q, chunk q + 1's rows and chunk q + 2's
// indices are in flight (a deeper ring of rows measured no faster).  Each staged row takes a 128-byte line of shared
// memory; its 16-byte units are permuted by an XOR with a key the kernel
// chooses from how its lanes read, so that the lanes of one load hit
// distinct banks.  Slots past the bucket's end are never read from global
// memory (their copies are zero-filled or not issued).
#pragma once

#include <string.h>

#include "common.cuh"
#include "mma.cuh"

namespace groot {

constexpr int kChunk = 32;  // edge slots per ring stage
constexpr int kLine = 128;  // shared-memory bytes per staged row
constexpr int kTile = 16;   // destination rows per tile (the MMA's M)

// Copy the first ``bytes`` of a kSize-byte piece (the rest zero-filled).
template <int kSize>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (kSize == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kSize), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of byte ``byte`` of staged row p, its 16-byte unit XORed with key.
__device__ __forceinline__ int line_offset(int p, int byte, int key) {
  return p * kLine + ((((byte >> 4) ^ key) & 7) << 4) + (byte & 15);
}

// N consecutive T of staged row ``line`` from byte ``byte0`` on (a whole
// number of 16-byte units, or a piece inside one), by the widest loads.
template <typename T, int N>
__device__ __forceinline__ void load_line(T (&v)[N], const unsigned char* line, int byte0,
                                          int key) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
    static_assert(kBytes % 16 == 0, "whole 16-byte units");
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          line + (((((byte0 >> 4) + u) ^ key) & 7) << 4));
      memcpy(&v[u * 16 / sizeof(T)], &w, 16);
    }
  } else {
    const unsigned char* at = line + ((((byte0 >> 4) ^ key) & 7) << 4) + (byte0 & 15);
    if constexpr (kBytes == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(at);
      memcpy(&v[0], &w, 8);
    } else if constexpr (kBytes == 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(at);
      memcpy(&v[0], &w, 4);
    } else {
      static_assert(kBytes == 2, "2, 4, 8 or a multiple of 16 bytes");
      const unsigned short w = *reinterpret_cast<const unsigned short*>(at);
      memcpy(&v[0], &w, 2);
    }
  }
}

// One warp's shared memory: two row stages, three meta stages.
template <typename T, int G>
struct alignas(128) Ring {
  unsigned char rows[2][kChunk * kLine];
  int32_t cols[3][kChunk];
  T w[3][kChunk * G];
};

// One chunk of a warp's walk.
struct Chunk {
  int64_t tile;   // tile index in the bucket
  int64_t start;  // first slot of the chunk in the bucket
  int begin;      // first slot of the chunk in its tile
  int n;          // slots in the chunk (fewer at the bucket's or the tile's end)
};

// The chunks of one warp's tiles, in order: tiles first, first + stride, ...,
// ``steps`` of them (a tile past the bucket's rows walks empty chunks).
struct Walk {
  int64_t first, stride, slots;
  int ld2, per_tile;  // log2(deg); chunks per tile
  int64_t count;      // chunks of this warp

  __device__ Walk(int64_t rows, int ld2_, int64_t first_, int64_t stride_, int64_t steps)
      : first(first_), stride(stride_), slots(rows << ld2_), ld2(ld2_),
        per_tile(((kTile << ld2_) + kChunk - 1) / kChunk), count(steps * per_tile) {}

  __device__ Chunk at(int64_t q) const {
    Chunk c;
    const int64_t i = q / per_tile;
    const int cc = static_cast<int>(q - i * per_tile);
    c.tile = first + i * stride;
    c.begin = cc * kChunk;
    c.start = (c.tile << (ld2 + 4)) + c.begin;
    const int64_t left = slots - c.start;
    const int in_tile = min(kChunk, (kTile << ld2) - c.begin);
    c.n = static_cast<int>(left < in_tile ? (left > 0 ? left : 0) : in_tile);
    return c;
  }
};

// Steps of a walk over units of ``group`` consecutive tiles, unit ``first``
// then every ``stride``-th, of a bucket of ``rows`` rows.
__device__ __forceinline__ int64_t walk_steps(int64_t rows, int group, int64_t first,
                                              int64_t stride) {
  const int64_t units = ((rows + kTile - 1) / kTile + group - 1) / group;
  return first < units ? (units - 1 - first) / stride + 1 : 0;
}

// Copies of a chunk's column indices and (kWeights) weights into meta stage m.
template <bool kWeights, typename T, int G>
__device__ __forceinline__ void issue_meta(Ring<T, G>& ring, int m, const Chunk& c,
                                           const int32_t* __restrict__ cols,
                                           const T* __restrict__ wg, int lane) {
  const int col_bytes = c.n * 4;
  if (lane * 16 < col_bytes)
    cp_async<16>(smem_u32(&ring.cols[m][0]) + lane * 16, cols + c.start + lane * 4,
                 min(16, col_bytes - lane * 16));
  if constexpr (kWeights) {
    constexpr int kWBytes = kChunk * G * static_cast<int>(sizeof(T));
    const int w_bytes = c.n * G * static_cast<int>(sizeof(T));
    const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(wg + c.start * G);
#pragma unroll
    for (int off = lane * 16; off < kWBytes; off += kWarp * 16)
      if (off < w_bytes)
        cp_async<16>(smem_u32(&ring.w[m][0]) + off, wsrc + off, min(16, w_bytes - off));
  }
}

// Copies of a chunk's gathered x rows (F of T each) into row stage s; the
// column indices come from meta stage m, which must have landed.  ``Key``
// maps (chunk slot, slot in tile) to the slot's unit permutation.
template <typename T, int F, typename Key, int G>
__device__ __forceinline__ void issue_rows(Ring<T, G>& ring, int s, int m, const Chunk& c,
                                           const T* __restrict__ x, int lane, Key key) {
  constexpr int kRow = F * static_cast<int>(sizeof(T));
  static_assert(kRow == 8 || (kRow % 16 == 0 && kRow <= kLine), "8 bytes or whole units");
  constexpr int kPiece = kRow < 16 ? kRow : 16;
  constexpr int kPer = kRow / kPiece;  // pieces a row
  const uint32_t base = smem_u32(&ring.rows[s][0]);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  for (int i = lane; i < c.n * kPer; i += kWarp) {
    const int p = i / kPer, byte = (i % kPer) * kPiece;
    const int64_t col = ring.cols[m][p];
    cp_async<kPiece>(base + line_offset(p, byte, key(p, c.begin + p)), xb + col * kRow + byte,
                     kPiece);
  }
}

// Run a warp's walk: on_chunk(chunk, staged rows, staged weights) for every
// chunk in order, once its copies have landed, and on_tile(tile) after a
// tile's last chunk (outside any branch: it may hold warpgroup-wide MMAs).
// Each step q commits two copy groups, meta q + 2 and rows q + 1; at the top
// of step q the groups in flight are meta q + 1 and rows q.  kWeights: the
// stream has weights (wg), else none are copied.
template <typename T, int F, bool kWeights, int G, typename Key, typename OnChunk,
          typename OnTile>
__device__ __forceinline__ void run_walk(Ring<T, G>& ring, const Walk& walk,
                                         const int32_t* __restrict__ cols,
                                         const T* __restrict__ wg, const T* __restrict__ x,
                                         int lane, Key key, OnChunk on_chunk, OnTile on_tile) {
  if (walk.count == 0) return;
  const Chunk first = walk.at(0);
  issue_meta<kWeights>(ring, 0, first, cols, wg, lane);
  cp_async_commit();
  if (walk.count > 1) issue_meta<kWeights>(ring, 1, walk.at(1), cols, wg, lane);
  cp_async_commit();
  cp_async_wait<1>();  // meta 0 has landed
  __syncwarp();
  issue_rows<T, F>(ring, 0, 0, first, x, lane, key);
  cp_async_commit();
  int ms = 0;  // meta stage of chunk q (rows stage: q % 2)
  for (int64_t q = 0; q < walk.count;) {
    Chunk c;
    for (int cc = 0; cc < walk.per_tile; ++cc, ++q) {
      c = walk.at(q);
      __syncwarp();  // every lane is done with the stages the next copies overwrite
      if (q + 2 < walk.count)
        issue_meta<kWeights>(ring, (ms + 2) % 3, walk.at(q + 2), cols, wg, lane);
      cp_async_commit();
      cp_async_wait<1>();  // meta q + 1 and rows q have landed
      __syncwarp();
      if (q + 1 < walk.count)
        issue_rows<T, F>(ring, static_cast<int>((q + 1) & 1), (ms + 1) % 3, walk.at(q + 1), x,
                         lane, key);
      cp_async_commit();
      on_chunk(c, static_cast<const unsigned char*>(ring.rows[q & 1]),
               static_cast<const T*>(ring.w[ms]));
      ms = ms == 2 ? 0 : ms + 1;
    }
    on_tile(c.tile);
  }
  cp_async_wait<0>();
}

// The grid of a persistent kernel walking ``units`` units of work: one block
// a unit, up to as many blocks as the card keeps resident at once.  Sets the
// kernel's dynamic shared memory first.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int64_t units,
                                   dim3& grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  grid = dim3(static_cast<unsigned>(units < cap ? units : cap));
  return err;
}

}  // namespace groot
