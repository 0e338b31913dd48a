// Instance reduction: kernel B2 of the PyTorch/CUDA port.
//
// Replaces rain_tpu/ops/expand.py:_reduce_kernel (entry reduce_instances),
// the transpose of the expansion. The TPU kernel multiplies each 256-wide
// chunk of rank-ordered gradient columns by the same interval one-hot the
// forward uses, on the MXU, and accumulates each output block in VMEM
// across the consecutive grid steps that visit it. That carry relies on
// the TPU running its grid in order, which a GPU grid does not.
//
// Contract. Gaussians arrive in depth order; Gaussian g owns the instances
// [exc[g], exc[g] + tiles[g]), clipped to M. For every row r and Gaussian g
//   out[r, g] = sum over g's instances i, in increasing i, of d[r, i],
// starting from 0.0f. Segments are contiguous and each instance has exactly
// one owner. Every element of out is written.
//
// Bound on the H100: bytes. Each live instance's rows are read once, each
// Gaussian's exc and tiles read once and its rows written once, with one
// add per instance and row.
//
// The first design (0.0175 ms at training step 0 of the 262k garden proxy,
// 58 % of its bound, and 0.367 ms, 23 %, at a Trainer step with 26
// instances per live Gaussian; H100 80GB HBM3 at 700 W) ran one thread per
// (row, Gaussian), each walking its segment in global memory: the 32 lanes
// of a warp read 32 different cache lines at each step, a warp waited for
// its longest segment, and exc and tiles were read once per row.
//
// This design (PERF.md has its times and ablations) is B1's instance-chunk
// schedule turned around. The segments tile [0, live), live = min(total,
// M), in Gaussian order.
// 1. A chunk block owns kChunk consecutive instances [i0, i0 + kChunk) and
//    the Gaussians whose segments start there and below live: lo <= g < hi
//    with exc[g] < live, lo the first g with exc[g] >= i0, hi the first
//    with exc[g] >= i0 + kChunk, found by warps 0 and 1 with 32-way ballot
//    searches (4 rounds at 786k Gaussians).
// 2. Meanwhile the other six warps read the instance count (as every
//    thread does; it stops the chunks past it) and stage all rows of the
//    chunk's live instances in shared memory with coalesced 16-byte
//    cp.async copies through L1 (4-byte ones when M % 4 != 0). A block
//    waits for its search and its copies only once, before it sums.
// 3. Thread t sums the segment of Gaussian lo + t (then + kThreads, ...)
//    from shared memory, all rows at once, in instance order from 0.0f,
//    reading its exc and tiles once. The order is the contract's, so the
//    result equals the plain version bit for bit.
// 4. Only the last owned segment can run past the chunk. Its partial sums
//    go to shared memory, and one thread per row adds the rest on, still
//    in order: up to kShortCarry instances straight from global memory,
//    a longer rest staged by the block a chunk at a time.
// 5. Tail blocks write the zeros of the Gaussians past the live instances
//    (culled ones, which come last in depth order, and segments wholly
//    clipped by M), kTail Gaussians each: an empty segment owns no
//    instance, so no chunk block would write it.
// 6. kMinBlocks = 5 resident blocks per SM (48 registers, 37 KB of shared
//    memory each), so that blocks waiting on their searches overlap the
//    copies of others.
// No atomics: the result is the same on every run.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;                // instances per chunk block
constexpr int kTail = 1024;                 // Gaussians per tail block
constexpr int kMaxRows = 16;
constexpr int kMinBlocks = 5;               // resident blocks per SM
constexpr int kShortCarry = 8;              // read from global memory
constexpr int kDefaultSmem = 48 * 1024;     // above this, opt in
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The first g in [0, n) with exc[g] >= target, or n. Called by a whole
// warp; every lane returns it. 32 probes per round cut the range 32-fold.
__device__ __forceinline__ int64_t warp_lower_bound(
    const int64_t* __restrict__ exc, int64_t n, int64_t target, int lane) {
  int64_t lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool above = p >= hi || exc[p] >= target;
    const unsigned ballot = __ballot_sync(kFull, above);
    if (ballot == 0u) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(ballot) - 1;
      hi = lo + j * step < hi ? lo + j * step : hi;
      if (j > 0) lo += (j - 1) * step + 1;
    }
  }
  return lo;
}

// One 16-byte cp.async that allocates in L1 (.ca). __pipeline_memcpy_async
// issues 16-byte copies around L1 (.cg), which was slower at training
// step 0, whose columns the scatter has just left in L2, and no faster at
// a Trainer step's, which come from device memory (PERF.md has the times).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Issue, as thread t of nt, the copies of columns [base, base + e) of
// every row into the staged rows' columns [0, e). With vec (M % 4 == 0)
// as 16-byte copies up to e rounded up, which stays inside the row. The
// caller commits and waits.
template <int R>
__device__ __forceinline__ void copy_rows(float* __restrict__ sd,
                                          const float* __restrict__ d,
                                          int rows, int64_t m, int64_t base,
                                          int e, bool vec, int t, int nt) {
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    if (vec) {
      for (int j = 4 * t; j < e; j += 4 * nt)
        copy16(sd + r * kChunk + j, d + r * m + base + j);
    } else {
      for (int j = t; j < e; j += nt)
        __pipeline_memcpy_async(sd + r * kChunk + j, d + r * m + base + j, 4);
    }
  }
}

// R rows; with kFixed every launch has exactly R rows, else rows <= R.
template <int R, bool kFixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks) reduce_kernel(
    const float* __restrict__ d, int rows_in, int64_t m,
    const int64_t* __restrict__ exc, const int32_t* __restrict__ tiles,
    int64_t n, int64_t n_chunks, bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float sd[];  // [rows][kChunk]
  __shared__ int64_t s_bound[2];
  __shared__ int64_t s_carry_g, s_carry_end;
  __shared__ float s_carry[R];
  const int rows = kFixed ? R : rows_in;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the instance count (one word, the same in every thread and block)
  const int64_t live = lmin(exc[n - 1] + tiles[n - 1], m);

  if (blockIdx.x >= n_chunks) {  // 5. a tail block
    const int64_t t0 = (blockIdx.x - n_chunks) * (int64_t)kTail;
    const int64_t t1 = lmin(t0 + kTail, n);
    if (exc[t1 - 1] < live) return;  // every segment here is live
    const bool all = exc[t0] >= live;
    for (int64_t g = t0 + tid; g < t1; g += kThreads) {
      if (all || exc[g] >= live) {
        for (int r = 0; r < R; ++r) {
          if (r >= rows) break;
          out[r * n + g] = 0.0f;
        }
      }
    }
    return;
  }

  // 1. warps 0 and 1 find the Gaussians whose segments start in the
  // chunk while 2. the other warps stage its live instances
  const int64_t i0 = (int64_t)blockIdx.x * kChunk;
  const int64_t chunk_end = i0 + kChunk;
  if (warp < 2) {
    const int64_t g =
        warp_lower_bound(exc, n, warp == 0 ? i0 : chunk_end, lane);
    if (lane == 0) s_bound[warp] = g;
  }
  if (i0 >= live) return;  // past the live instances: nothing to sum
  if (warp >= 2)
    copy_rows<R>(sd, d, rows, m, i0, (int)(lmin(chunk_end, live) - i0), vec,
                 tid - 64, kThreads - 64);
  __pipeline_commit();
  if (tid == 0) s_carry_g = -1;
  __pipeline_wait_prior(0);
  __syncthreads();
  const int64_t lo = s_bound[0], hi = s_bound[1];

  // 3. one thread per owned Gaussian, all rows, in order from 0.0f
  for (int64_t g = lo + tid; g < hi; g += kThreads) {
    const int64_t b = exc[g];
    if (b >= live) break;  // this and the later ones are the tail's
    const int64_t stop = b + (int64_t)tiles[g];
    const int64_t e = lmin(stop, m);
    const int j_end = (int)(lmin(e, chunk_end) - i0);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int j = (int)(b - i0); j < j_end; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (kFixed || r < rows) acc[r] = acc[r] + sd[r * kChunk + j];
    }
    if (e > chunk_end) {  // 4. runs past the chunk: carried on below
#pragma unroll
      for (int r = 0; r < R; ++r) s_carry[r] = acc[r];
      s_carry_g = g;
      s_carry_end = e;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (kFixed || r < rows) out[r * n + g] = acc[r];
    }
  }
  __syncthreads();

  // 4. the segment that runs past the chunk: a short rest read by its row
  // threads from global memory, all loads at once; a long one staged a
  // chunk at a time
  const int64_t cg = s_carry_g;
  if (cg < 0) return;
  const int64_t c_end = s_carry_end;
  float acc = tid < rows ? s_carry[tid] : 0.0f;
  if (c_end - chunk_end <= kShortCarry) {
    if (tid < rows) {
      const int len = (int)(c_end - chunk_end);
      const float* row = d + tid * m + chunk_end;
      float v[kShortCarry];
#pragma unroll
      for (int j = 0; j < kShortCarry; ++j) v[j] = j < len ? row[j] : 0.0f;
#pragma unroll
      for (int j = 0; j < kShortCarry; ++j)
        if (j < len) acc = acc + v[j];
      out[tid * n + cg] = acc;
    }
    return;
  }
  for (int64_t p = chunk_end; p < c_end; p += kChunk) {
    const int len = (int)lmin(c_end - p, kChunk);
    __syncthreads();  // the previous piece is read
    copy_rows<R>(sd, d, rows, m, p, len, vec, tid, kThreads);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (tid < rows) {
      const float* row = sd + tid * kChunk;
      for (int j = 0; j < len; ++j) acc = acc + row[j];
    }
  }
  if (tid < rows) out[tid * n + cg] = acc;
}

template <int R, bool kFixed>
int launch(cudaStream_t stream, const float* d, int rows, int64_t m,
           const int64_t* exc, const int32_t* tiles, int64_t n, float* out) {
  const int64_t chunks = (m + kChunk - 1) / kChunk;
  const int64_t tails = (n + kTail - 1) / kTail;
  const int smem = rows * kChunk * (int)sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reduce_kernel<R, kFixed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = m % 4 == 0 && (uintptr_t)d % 16 == 0;
  reduce_kernel<R, kFixed><<<(unsigned)(chunks + tails), kThreads, smem,
                             stream>>>(d, rows, m, exc, tiles, n, chunks, vec,
                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. rows must lie in [0, 16].
extern "C" int rain_reduce_instances(int device, void* stream, const void* d,
                                     int rows, int64_t m, const void* exc,
                                     const void* tiles, int64_t n,
                                     void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n == 0 || rows == 0) return 0;
  const auto s = (cudaStream_t)stream;
  const auto* dp = (const float*)d;
  const auto* ep = (const int64_t*)exc;
  const auto* tp = (const int32_t*)tiles;
  if (rows == 9)  // the pack's gradient rows: the main path
    return launch<9, true>(s, dp, rows, m, ep, tp, n, (float*)out);
  return launch<kMaxRows, false>(s, dp, rows, m, ep, tp, n, (float*)out);
}

// Resident blocks per SM of the main path's kernel (9 rows), into *blocks.
extern "C" int rain_reduce_occupancy(int device, void* stream, void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, reduce_kernel<9, true>, kThreads,
      9 * kChunk * (int)sizeof(float));
}
