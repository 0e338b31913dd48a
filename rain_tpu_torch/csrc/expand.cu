// Instance expansion: kernel B1 of the PyTorch/CUDA port.
//
// Replaces rain_tpu/ops/expand.py:_kernel (entry expand_instances), which
// selects each instance's per-Gaussian column on the TPU's MXU with a
// windowed one-hot matmul, carries the integer streams as f32 (12-bit halves
// of the offsets, the original index) and leaves the tile key to XLA.
//
// Contract. Gaussians arrive in depth order; Gaussian g owns the instances
// i with exc[g] <= i < offs[g] (offs = inclusive prefix sum of its tile
// count). For every i < min(total, M) the kernel writes
//   out[r, i] = table[r, g]                       for the 10 pack rows, and
//   keys[i]   = tile << 32 | g                    (g = depth rank),
// where tile is the (i - exc[g])-th tile of g's rect in row-major order
// (binning.py:418-428, the reference's duplicateWithKeys). Columns
// i >= min(total, M) are zero and their key is n_tiles << 32, so they sort
// last. Gaussians with no tile may sit anywhere in the order.
//
// Bound on the H100: bytes. Each Gaussian's 60 bytes are read once and
// each instance's 40-byte column and 8-byte key written once; there is no
// arithmetic to speak of.
//
// The first design (0.0345 ms on an H100 80GB HBM3 at 700 W, 46 % of its
// 0.0160 ms bound, training step 0 of the 262k garden proxy) ran one
// thread per instance: an 18-step binary search over the offsets in every
// thread before its first store, 64-bit division for the tile, ten 4-byte
// gathers at stride N per instance and eleven scalar stores.
//
// This design (PERF.md has its times and ablations). The owner is
// non-decreasing in the instance index, so the kChunk consecutive
// instances of a block are owned by a contiguous window of depth-ordered
// Gaussians, whose data is contiguous in memory.
// 1. A block owns kChunk = kThreads * kV instances; thread t the kV
//    adjacent columns from kV * t. A chunk at or past min(total, M) only
//    writes zeros and pad keys.
// 2. Warps 0 and 1 find the owners of the chunk's first and last column,
//    each with one warp-cooperative search: 32 lanes probe 32 points and a
//    ballot cuts the range 32-fold per round (4 rounds for 262k
//    Gaussians). They start while one thread reads the instance count;
//    the one chunk where the live instances end searches its last one
//    again.
// 3. The window's offsets, tile counts and rects are copied into shared
//    memory with coalesced cp.async, kWindow Gaussians at a time (a window
//    holds at most kChunk Gaussians with a tile, but any number without
//    one). Each thread binary-searches its first column's owner there and
//    walks forward; each column's owner and key stay in registers until
//    every piece of the window has passed.
// 4. 32-bit index math: one division per thread and owner run; the next
//    instance of an owner steps dx and wraps to the next dy, and a new
//    owner starts at its rect's first tile. The wrapper keeps N, M < 2^31.
// 5. Row by row, each thread gathers its columns' table values (neighbours
//    share owners, so the gathers hit in L1; staging the table rows in
//    shared memory as well was no faster) and stores them as one float4
//    when every row starts 16-byte aligned (M % 4 == 0), the keys as
//    16-byte pairs; otherwise, and at the ragged end, as scalar stores.
// 6. Few registers and 20 KB of shared memory, so that kMinBlocks = 6
//    blocks fit on an SM and the 768 blocks of M = 786,432 run in one wave:
//    a block stores nothing until its search and window have arrived, and
//    a second wave would wait for that latency again. No atomics.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 10;
constexpr int kThreads = 256;
constexpr int kV = 4;                      // adjacent columns per thread
constexpr int kChunk = kThreads * kV;      // instances per block
constexpr int kWindow = 1024;              // Gaussians staged at a time
constexpr int kMinBlocks = 6;              // resident blocks per SM
constexpr unsigned kFull = 0xffffffffu;
using Index = int32_t;                     // the tile arithmetic's integers

// The staged window of the owners' offsets and rects, in dynamic shared
// memory (20 KB, below the 48 KB that needs no opt-in).
struct Window {
  int64_t offs[kWindow];
  int32_t tiles[kWindow];
  int32_t rect_w[kWindow];
  int32_t rect_base[kWindow];
};
constexpr int kSmem = (int)sizeof(Window);

// The owner of instance `target` (< offs[n - 1]): the first g with
// offs[g] > target. Called by a whole warp; every lane returns it. For a
// target at or past offs[n - 1] it returns n - 1, without reading past it.
__device__ __forceinline__ int warp_owner(const int64_t* __restrict__ offs,
                                          int n, int64_t target, int lane) {
  int64_t lo = 0, hi = n - 1;  // the owner is in [lo, hi]; offs[hi] > target
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool above = p >= hi || offs[p] > target;
    const unsigned ballot = __ballot_sync(kFull, above);
    if (ballot == 0u) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(ballot) - 1;
      hi = lo + j * step < hi ? lo + j * step : hi;
      if (j > 0) lo += (j - 1) * step + 1;
    }
  }
  return (int)lo;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) expand_kernel(
    const float* __restrict__ table, int n,
    const int32_t* __restrict__ tiles, const int64_t* __restrict__ offs,
    const int32_t* __restrict__ rect_w, const int32_t* __restrict__ rect_base,
    int m, int grid_x, int tile_offset, int n_tiles, bool vec_rows,
    bool vec_keys, float* __restrict__ out, int64_t* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  Window& w = *reinterpret_cast<Window*>(smem);
  __shared__ int s_owner[2];
  __shared__ int64_t s_total;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // instance positions in int64: m < 2^31, but m + kChunk need not be
  const int64_t i0 = (int64_t)blockIdx.x * kChunk;
  const int64_t c0 = i0 + kV * tid;  // this thread's first column
  const int64_t end = i0 + kChunk < m ? i0 + kChunk : m;
  // one read of the instance count per block (every block reads the same
  // word) while warps 0 and 1 search the owners of the chunk's first and
  // last column (searched again below for the one chunk where the live
  // instances end)
  if (tid == 64) s_total = n > 0 ? offs[n - 1] : 0;
  int owner = 0;
  if (warp < 2) owner = warp_owner(offs, n, warp == 0 ? i0 : end - 1, lane);
  if (warp < 2 && lane == 0) s_owner[warp] = owner;
  __syncthreads();
  const int64_t total = s_total;
  const int64_t live = total < m ? total : m;

  int g[kV];        // each column's owner
  int64_t key[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    g[v] = 0;
    key[v] = (int64_t)n_tiles << 32;
  }

  if (i0 < live) {
    if (live < end) {  // the last live instance is live - 1
      if (warp == 1) {
        owner = warp_owner(offs, n, live - 1, lane);
        if (lane == 0) s_owner[1] = owner;
      }
      __syncthreads();
    }
    const int g0 = s_owner[0], g1 = s_owner[1];
    const int64_t c_end = c0 + kV < live ? c0 + kV : live;
    int64_t lo = i0;  // instances below lo belong to earlier pieces
    for (int64_t a = g0; a <= g1; a += kWindow) {
      const int len = (int)(g1 - a + 1 < kWindow ? g1 - a + 1 : kWindow);
      if (a != g0) __syncthreads();  // the previous piece is read
      for (int j = tid; j < len; j += kThreads) {
        __pipeline_memcpy_async(&w.offs[j], offs + a + j, 8);
        __pipeline_memcpy_async(&w.tiles[j], tiles + a + j, 4);
        __pipeline_memcpy_async(&w.rect_w[j], rect_w + a + j, 4);
        __pipeline_memcpy_async(&w.rect_base[j], rect_base + a + j, 4);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const int64_t hi = w.offs[len - 1];  // this piece owns [lo, hi)
      int j = -1;
      Index dx = 0, dy = 0, wd = 1;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int64_t i = c0 + v;
        if (i >= lo && i < hi && i < c_end) {
          if (j < 0) {
            int s = 0, e = len - 1;  // first j with offs[j] > i
            while (s < e) {
              const int mid = (s + e) >> 1;
              if (w.offs[mid] > i) {
                e = mid;
              } else {
                s = mid + 1;
              }
            }
            j = s;
            const Index local = (Index)(i - (w.offs[j] - w.tiles[j]));
            wd = max(w.rect_w[j], 1);
            dy = local / wd;
            dx = local - dy * wd;
          } else if (w.offs[j] > i) {  // the same owner: the next tile
            if (++dx == wd) {
              dx = 0;
              ++dy;
            }
          } else {  // the next owner with a tile starts at its first tile
            do {
              ++j;
            } while (w.offs[j] <= i);
            wd = max(w.rect_w[j], 1);
            dx = 0;
            dy = 0;
          }
          const int64_t tile = (int64_t)w.rect_base[j] + (int64_t)dy * grid_x +
                               dx - tile_offset;
          g[v] = (int)(a + j);
          key[v] = (int64_t)((uint64_t)tile << 32) | g[v];
        }
      }
      lo = hi;
    }
  }

  if (c0 >= m) return;
  const bool whole = c0 + kV <= m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // neighbouring columns mostly share an owner: the gathers hit in L1
    float x[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v)
      x[v] = c0 + v < live ? table[(int64_t)r * n + g[v]] : 0.0f;
    float* row = out + (int64_t)r * m + c0;
    if constexpr (kV % 4 == 0) {
      if (vec_rows && whole) {
#pragma unroll
        for (int v = 0; v < kV; v += 4)
          *reinterpret_cast<float4*>(row + v) =
              make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
        continue;
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (c0 + v < m) row[v] = x[v];
  }
  if constexpr (kV % 2 == 0) {
    if (vec_keys && whole) {
#pragma unroll
      for (int v = 0; v < kV; v += 2)
        *reinterpret_cast<longlong2*>(keys + c0 + v) =
            make_longlong2(key[v], key[v + 1]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < kV; ++v)
    if (c0 + v < m) keys[c0 + v] = key[v];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. n and m must be below 2^31.
extern "C" int rain_expand_instances(
    int device, void* stream, const void* table, int64_t n, const void* tiles,
    const void* offs, const void* rect_w, const void* rect_base, int64_t m,
    int grid_x, int tile_offset, int n_tiles, void* out, void* keys) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  if (n > INT32_MAX || m > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool vec_rows = m % 4 == 0 && (uintptr_t)out % 16 == 0;
  const bool vec_keys = (uintptr_t)keys % 16 == 0;
  const int64_t blocks = (m + kChunk - 1) / kChunk;
  expand_kernel<<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)table, (int)n, (const int32_t*)tiles,
      (const int64_t*)offs, (const int32_t*)rect_w,
      (const int32_t*)rect_base, (int)m, grid_x, tile_offset, n_tiles,
      vec_rows, vec_keys, (float*)out, (int64_t*)keys);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel (cudaOccupancy...), into *blocks.
extern "C" int rain_expand_occupancy(int device, void* stream, void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, expand_kernel, kThreads, kSmem);
}
