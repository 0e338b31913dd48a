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
// Bound on the H100: f32 operations. Every (pixel, instance) pair costs
// ~14 operations for the power and alpha and ~12 more when it composites,
// against 40 bytes per instance read once for 256 pixels.
//
// Design. One 256-thread block per 16x16 tile. Each batch of 256 instances
// is loaded once into shared memory as structure-of-arrays rows (coalesced
// column reads; every thread then reads the same shared word, a
// broadcast), and each thread walks it sequentially, so pixels that
// saturate stop early. __syncthreads_count ends the batch loop for the whole
// block once every pixel is done. The arithmetic is written in the same
// order as the plain PyTorch version (ops/tile_render.py), and the library
// is built with -fmad=false, so the two round alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile = threads per block
constexpr int kRows = 10;            // pack rows read (ROW_A .. ROW_DEPTH)

enum Row { kA, kB, kC, kXg, kYg, kOp, kR, kG, kB2, kDepth };

__global__ void __launch_bounds__(kPix) composite_fwd_kernel(
    const float* __restrict__ pack, int64_t m,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    int toff, int grid_x, float* __restrict__ out) {
  __shared__ float s[kRows][kPix];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int gt = t + toff;
  const float px = (float)((gt % grid_x) * kTile + tid % kTile);
  const float py = (float)((gt / grid_x) * kTile + tid / kTile);
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
  for (int base = start; base < end; base += kPix) {
    // a block-wide barrier (the previous batch is fully read) and a vote
    if (__syncthreads_count(!done) == 0) break;
    const int64_t idx = (int64_t)base + tid;
    if (idx < end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r][tid] = pack[r * m + idx];
    }
    __syncthreads();
    const int cnt = min(kPix, end - base);
    for (int j = 0; j < cnt && !done; ++j) {
      const float dx = s[kXg][j] - px;
      const float dy = s[kYg][j] - py;
      const float power = -0.5f * (s[kA][j] * dx * dx + s[kC][j] * dy * dy) -
                          s[kB][j] * dx * dy;
      // written so that a NaN power skips, as in the plain version
      if (!(power <= 0.0f)) continue;
      const float alpha = fminf(s[kOp][j] * expf(power), alpha_clamp);
      if (alpha < alpha_min) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < t_eps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      cr = cr + w * s[kR][j];
      cg = cg + w * s[kG][j];
      cb = cb + w * s[kB2][j];
      depth = depth + w * s[kDepth][j];
      asum = asum + w;
      T = test_t;
      last = base - start + j + 1;
    }
  }
  float4* o = reinterpret_cast<float4*>(out + ((int64_t)t * kPix + tid) * 8);
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
