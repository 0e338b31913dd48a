// Backward tile compositor: kernel B4 of the PyTorch/CUDA port.
//
// Replaces rain_tpu/ops/tile_render.py:_bwd_kernel (entry
// _composite_bwd_impl, row remap _composite_bwd). The TPU kernel
// re-evaluates each 256-pixel x 256-instance block as matmuls and lane
// scans, takes the geometric gradients as moment sums against the
// quadratic pixel basis, and writes compact gradient columns, holding each
// tile's last 256-wide window in VMEM across grid steps (the TPU runs its
// grid in order) because Mosaic DMA windows must be aligned.
//
// Contract (tile_render.py:573-627). Block t re-walks tile t (global tile
// t + toff of a grid grid_x tiles wide) over the pack columns
// [starts[t], ends[t]) with B3's rules, given B3's output tiles (channel 5
// final_T, channel 6 n_contrib) and the cotangent g_tiles; only channels
// r, g, b (0..2) and final_T (5) of the cotangent are read. For each pixel
// and each instance k it composited (k < n_contrib, power <= 0,
// alpha >= 1/255), front to back with T_k the transmittance in front of k:
//   S       <- S - alpha_k T_k (c_k . g),   S starting at C . g
//   dL/dalpha_k = T_k (c_k . g) - (S + T_final g_T) / (1 - alpha_k)
//   gd = dL/dalpha_k * e^power  (the 0.99 clamp passes the gradient),
//   dpow = gd * op, and, with dx = xg - px, dy = yg - py in global pixels,
//   d a = -dpow dx^2 / 2, d b = -dpow dx dy, d c = -dpow dy^2 / 2,
//   d xg = -dpow (a dx + b dy), d yg = -dpow (c dy + b dx),
//   d op = gd, d rgb = alpha_k T_k g_rgb.
// d_pack[row, i] (pack row layout, rows 0..8) is the sum over the tile's
// 256 pixels. The caller zeroes d_pack; columns no block walks stay zero.
// The depth row takes no gradient.
//
// Bound on the H100: f32 operations. Every pair a pixel walks costs ~14
// operations for the power and alpha; every composited pair ~47 more for
// its gradients and its share of the sums, against 36 bytes per instance
// read once for 256 pixels.
//
// Design. One 256-thread block per 16x16 tile, one thread per pixel, and
// instances in shared-memory batches of 128, as in B3. A block walks only
// up to the largest n_contrib of its pixels, so early termination carries
// over from the forward. No float atomics: each instance belongs to one
// tile, so its block reduces the 256 pixels' 9 contributions in a fixed
// order - a shuffle-down tree in each warp, whose lane 0 stores the warp's
// sum to shared memory (a warp with no active pixel stores zeros), then the
// 8 warp sums added in warp order - and writes the column once. The
// arithmetic is written in the same order as the plain PyTorch version
// (ops/tile_render.py:composite_backward_torch), which emulates the same
// reduction tree, and the library is built with -fmad=false, so the two
// round alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 128;          // instances per shared-memory batch
constexpr int kRows = 9;             // gradient rows (ROW_A .. ROW_B2)
constexpr unsigned kFull = 0xffffffffu;

enum Row { kA, kB, kC, kXg, kYg, kOp, kR, kG, kB2 };

__global__ void __launch_bounds__(kPix) composite_bwd_kernel(
    const float* __restrict__ pack, int64_t m,
    const int32_t* __restrict__ starts, int toff, int grid_x,
    const float* __restrict__ tiles, const float* __restrict__ g_tiles,
    float* __restrict__ d_pack) {
  __shared__ float s[kRows][kBatch];
  __shared__ float part[kWarps][kRows][kBatch];
  __shared__ int warp_last[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gt = t + toff;
  const float px = (float)((gt % grid_x) * kTile + tid % kTile);
  const float py = (float)((gt / grid_x) * kTile + tid / kTile);
  const int64_t start = starts[t];
  // the constants as f32 roundings of the reference's double literals
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_clamp = (float)0.99;

  const float* o = tiles + ((int64_t)t * kPix + tid) * 8;
  const float* gp = g_tiles + ((int64_t)t * kPix + tid) * 8;
  const float g_r = gp[0], g_g = gp[1], g_b = gp[2];
  const float bg = o[5] * gp[5];        // T_final * g_T
  const int last = (int)o[6];           // n_contrib
  float rest = o[0] * g_r + o[1] * g_g + o[2] * g_b;   // C . g
  float T = 1.0f;

  const int wl = __reduce_max_sync(kFull, last);
  if (lane == 0) warp_last[warp] = wl;
  __syncthreads();
  int n_walk = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_walk = max(n_walk, warp_last[w]);

  for (int base = 0; base < n_walk; base += kBatch) {
    const int cnt = min(kBatch, n_walk - base);
    __syncthreads();  // the previous batch's sums are written out
    if (tid < cnt) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r][tid] = pack[r * m + start + base + tid];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      float c[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) c[q] = 0.0f;
      bool active = false;
      if (base + j < last) {
        const float a = s[kA][j], b = s[kB][j], cc = s[kC][j];
        const float dx = s[kXg][j] - px;
        const float dy = s[kYg][j] - py;
        const float power = -0.5f * (a * dx * dx + cc * dy * dy) - b * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float op = s[kOp][j];
          const float alpha = fminf(op * G, alpha_clamp);
          if (alpha >= alpha_min) {
            active = true;
            const float cgd = g_r * s[kR][j] + g_g * s[kG][j] + g_b * s[kB2][j];
            const float om = 1.0f - alpha;
            const float w = alpha * T;
            rest = rest - w * cgd;
            const float dalpha = T * cgd - (rest + bg) / om;
            T = T * om;
            const float gd = dalpha * G;
            const float dpow = gd * op;
            const float hx = dx * dx, hy = dy * dy, hxy = dx * dy;
            c[kA] = -0.5f * dpow * hx;
            c[kB] = -dpow * hxy;
            c[kC] = -0.5f * dpow * hy;
            c[kXg] = -dpow * (a * dx + b * dy);
            c[kYg] = -dpow * (cc * dy + b * dx);
            c[kOp] = gd;
            c[kR] = w * g_r;
            c[kG] = w * g_g;
            c[kB2] = w * g_b;
          }
        }
      }
      if (__any_sync(kFull, active)) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            c[q] = c[q] + __shfl_down_sync(kFull, c[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) part[warp][q][j] = c[q];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kRows * cnt; idx += kPix) {
      const int q = idx / cnt;
      const int j = idx - q * cnt;
      float sum = part[0][q][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = sum + part[w][q][j];
      d_pack[q * m + start + base + j] = sum;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. d_pack must be zeroed by the caller.
extern "C" int rain_composite_backward(int device, void* stream,
                                       const void* pack, int64_t m,
                                       const void* starts, int n_tiles,
                                       int toff, int grid_x,
                                       const void* tiles, const void* g_tiles,
                                       void* d_pack) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  composite_bwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)pack, m, (const int32_t*)starts, toff, grid_x,
      (const float*)tiles, (const float*)g_tiles, (float*)d_pack);
  return (int)cudaGetLastError();
}
