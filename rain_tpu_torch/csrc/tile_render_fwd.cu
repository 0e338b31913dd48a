// Forward tile compositor: kernel B3 of the PyTorch/CUDA port.
//
// Replaces rain_tpu/ops/tile_render.py:_fwd_kernel (entry
// _composite_fwd_impl). The TPU kernel evaluates a 256-pixel x 256-instance
// block at a time: the Gaussian powers as one quadratic-basis matmul, the
// transmittance as a lane-axis cumulative-product scan, colour as a second
// matmul, with double-buffered 256-wide DMA of the instance stream.
//
// Contract. Block t composites tile t (global tile t + toff of a grid
// grid_x tiles wide) over the pack columns [starts[t], ends[t]), front to
// back, one thread per pixel, with the reference's rules
// (cuda_rasterizer/forward.cu:251-369):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = xg - px (global pixels)
//   skip when power > 0; alpha = min(0.99, op e^power); skip alpha < 1/255;
//   stop before compositing when T (1 - alpha) < 1e-4, keeping T.
// Each pixel writes [r, g, b, depth, alpha_sum, final_T, n_contrib, 0]
// (no background); n_contrib is the 1-based position in the tile's range of
// the last instance composited.
//
// Bound on the H100: f32 operations. Every (pixel, instance) pair that a
// front-to-back compositor evaluates costs ~14 operations for the power
// and alpha and ~12 more when it composites, against 40 bytes per
// instance read once for 256 pixels: 0.075 ms for training step 0 of the
// 262k garden proxy at 1297x840 (157 M pairs evaluated, 25 M composited).
//
// The first design (0.266 ms on an H100 80GB HBM3 at 700 W, 28 % of
// its 0.075 ms bound, on the 262k garden proxy's training step) walked
// every pair through expf, although ~84 % of the evaluated pairs fail
// alpha >= 1/255; whole warps walked instances whose footprint misses
// their 16x2 pixel strip; heavy tiles could start in the last wave; each
// batch read six structure-of-arrays words per pair from shared memory.
//
// This design (0.138 ms on the same card and inputs, 54 % of the bound;
// PERF.md). One 256-thread block per 16x16 tile; 256-instance batches
// in shared memory, one 48-byte record per instance, so a pair reads its
// inputs as two broadcast float4 loads (a third when it composites). Warp
// w composites an 8x4 pixel block (composite_cull.cuh:pixel_of). When a
// batch arrives each thread derives, for its instance, the power floor
// and the block mask of composite_cull.cuh; each warp then walks, 32
// instances at a time, only those whose ellipse can reach its block (a
// ballot of their mask bits, visited in order), and a pixel skips a pair
// whose power is below the floor before the exponential. Both only skip
// pairs that the rules above skip, so the output is that of the plain
// version bit for bit. The next batch is copied with cp.async while the
// current one is walked. Tiles run in launch order: taking the longest
// first saved 4 % of the kernel, and the sort of the range lengths cost
// more than ten times that (PERF.md). __syncthreads_count ends the batch
// loop once every pixel of the block is done. The arithmetic is written in
// the same order as the plain PyTorch version (ops/tile_render.py), and the
// library is built with -fmad=false, so the two round alike.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_cull.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile = threads per block
constexpr int kRows = 10;            // pack rows read (ROW_A .. ROW_DEPTH)
constexpr int kRec = 12;             // floats per instance record
constexpr unsigned kFull = 0xffffffffu;

// pack row -> record slot. Record: {xg, yg, a, b}, {c, op, floor, strip
// mask bits}, {r, g, b, depth}.
__constant__ int kSlot[kRows] = {2, 3, 4, 0, 1, 5, 8, 9, 10, 11};

__device__ __forceinline__ void fetch(float (*rec)[kRec],
                                      const float* __restrict__ pack,
                                      int64_t m, int64_t idx, int end,
                                      int tid) {
  if (idx < end) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      __pipeline_memcpy_async(&rec[tid][kSlot[r]], pack + r * m + idx, 4);
  }
}

__global__ void __launch_bounds__(kPix) composite_fwd_kernel(
    const float* __restrict__ pack, int64_t m,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    int toff, int grid_x, float* __restrict__ out) {
  __shared__ __align__(16) float s[2][kPix][kRec];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pix = rain_cull::pixel_of(tid);  // warp w: an 8x4 pixel block
  const int gt = t + toff;
  const int tx0 = (gt % grid_x) * kTile;
  const int ty0 = (gt / grid_x) * kTile;
  const float px = (float)(tx0 + pix % kTile);
  const float py = (float)(ty0 + pix / kTile);
  const int start = starts[t];
  const int end = ends[t];
  // the constants as f32 roundings of the reference's double literals
  const float alpha_min = (float)(1.0 / 255.0);
  const float t_eps = (float)1e-4;
  const float alpha_clamp = (float)0.99;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  float asum = 0.0f;
  int last = 0;
  bool done = false;
  int buf = 0;
  fetch(s[0], pack, m, (int64_t)start + tid, end, tid);
  __pipeline_commit();
  for (int base = start; base < end; base += kPix, buf ^= 1) {
    // a block-wide barrier (the other buffer is fully read) and a vote
    if (__syncthreads_count(!done) == 0) break;
    fetch(s[buf ^ 1], pack, m, (int64_t)base + kPix + tid, end, tid);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    if (base + tid < end) {
      float* q = s[buf][tid];
      const float floor = rain_cull::power_floor(q[5], alpha_min);
      q[6] = floor;
      q[7] = __uint_as_float(rain_cull::block_mask(q[2], q[3], q[4], q[0],
                                                   q[1], floor, tx0, ty0));
    }
    __syncthreads();
    const float4* rec = reinterpret_cast<const float4*>(s[buf]);
    const int cnt = min(kPix, end - base);
    // 32 instances at a time, the warp walks those that can reach its block
    for (int k = 0; k < cnt; k += 32) {
      const bool reach =
          k + lane < cnt &&
          ((__float_as_uint(rec[3 * (k + lane) + 1].w) >> warp) & 1u);
      unsigned list = __ballot_sync(kFull, reach);
      while (list != 0u && !done) {
        const int j = k + __ffs(list) - 1;
        list &= list - 1u;
        const float4 q0 = rec[3 * j];
        const float4 q1 = rec[3 * j + 1];
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                            q0.w * dx * dy;
        // written so that a NaN power skips, as in the plain version
        if (!(power <= 0.0f)) continue;
        if (power < q1.z) continue;
        const float alpha = fminf(q1.y * expf(power), alpha_clamp);
        if (alpha < alpha_min) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < t_eps) {
          done = true;
          break;
        }
        const float4 q2 = rec[3 * j + 2];
        const float w = alpha * T;
        cr = cr + w * q2.x;
        cg = cg + w * q2.y;
        cb = cb + w * q2.z;
        depth = depth + w * q2.w;
        asum = asum + w;
        T = test_t;
        last = base - start + j + 1;
      }
    }
  }
  __pipeline_wait_prior(0);
  float4* o = reinterpret_cast<float4*>(out + ((int64_t)t * kPix + pix) * 8);
  o[0] = make_float4(cr, cg, cb, depth);
  o[1] = make_float4(asum, T, (float)last, 0.0f);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int rain_composite_forward(int device, void* stream,
                                      const void* pack, int64_t m,
                                      const void* starts, const void* ends,
                                      int n_tiles, int toff, int grid_x,
                                      void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  composite_fwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)pack, m, (const int32_t*)starts, (const int32_t*)ends,
      toff, grid_x, (float*)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel (cudaOccupancy...), into *blocks.
extern "C" int rain_composite_forward_occupancy(int device, void* stream,
                                                void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, composite_fwd_kernel, kPix, 0);
}
