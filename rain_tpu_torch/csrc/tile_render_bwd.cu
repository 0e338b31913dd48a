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
// Contract (tile_render.py:573-627). Tile t re-walks the pack columns
// [starts[t], ends[t]) (global tile t + toff of a grid grid_x tiles wide)
// with B3's rules, given B3's output tiles (channel 5 final_T, channel 6
// n_contrib) and the cotangent g_tiles; only channels r, g, b (0..2) and
// final_T (5) of the cotangent are read. For each pixel and each instance
// k it composited (k < n_contrib, power <= 0, alpha >= 1/255), front to
// back with T_k the transmittance in front of k:
//   S       <- S - alpha_k T_k (c_k . g),   S starting at C . g
//   dL/dalpha_k = T_k (c_k . g) - (S + T_final g_T) / (1 - alpha_k)
//   gd = dL/dalpha_k * e^power  (the 0.99 clamp passes the gradient),
//   dpow = gd * op, and, with dx = xg - px, dy = yg - py in global pixels,
//   d a = -dpow dx^2 / 2, d b = -dpow dx dy, d c = -dpow dy^2 / 2,
//   d xg = -dpow (a dx + b dy), d yg = -dpow (c dy + b dx),
//   d op = gd, d rgb = alpha_k T_k g_rgb.
// d_pack[row, i] (pack row layout, rows 0..8) is the sum over the tile's
// 256 pixels. The kernel writes every element of the [16, M] d_pack: rows
// 9..15 (depth and padding) and every column that no tile walks are zero.
// The ranges must be ascending and disjoint, as ops/binning.py:tile_ranges
// makes them: tile t also zeroes the gap up to starts[t + 1] (tile 0 the
// columns before starts[0]), and the first `n_fill` blocks zero the
// columns from ends[n_tiles - 1] to M.
//
// Bound on the H100: f32 operations. Every pair a pixel walks costs ~14
// operations for the power and alpha; every composited pair ~47 more for
// its gradients and its share of the sums, against 36 bytes per instance
// read once for 256 pixels: 0.097 ms for training step 0 of the 262k
// garden proxy at 1297x840 (147 M pairs walked, 25 M composited).
//
// The first design (0.787 ms on an H100 80GB HBM3 at 700 W with the
// separate [16, M] zero fill of its output, which takes 0.019 ms) walked
// a tile's instances one at a time and, at every instance with one active
// pixel in a warp, ran a shuffle-down tree over all nine gradient rows:
// 45 shuffles and 45 adds per warp, then nine shared stores, while the
// other 31 lanes waited.
//
// This design (0.44 ms on the same card and inputs, 22 % of the bound;
// PERF.md) separates the walk from the reduction, in chunks of kChunk =
// 32 instances, one 256-thread block per 16x16 tile:
//   Phase A: one thread per pixel, warp w on an 8x4 pixel block
//   (composite_cull.cuh:pixel_of), walks the chunk front to back up to
//   its n_contrib (power, alpha, rest, T, dL/dalpha as above) and stores,
//   for each pair it composites, gd and w = alpha T into a [32][256 + 8]
//   tile in shared memory; a __ballot_sync per (instance, warp) records
//   which pixels composited. A warp visits only the instances whose
//   alpha >= 1/255 ellipse can reach its block (composite_cull.cuh's
//   block mask; a ballot over the chunk gives the list), which only skips
//   pairs that fail the rules above.
//   Phase B: thread (j, s) = (tid / 8, tid % 8) sums, for instance j, the
//   terms of the composited pixels of threads s + 8 i, i = 0 .. 31, in
//   ascending order from +0.0, visiting only the set bits of a mask
//   gathered from the ballot words (shared memory is indexed by thread).
//   The nine sums are the moments M = sum dpow (dx, dy, dx^2, dy^2, dx dy),
//   dpow = gd op, and the sums of gd and w g_rgb. A shuffle-down tree adds
//   the 8 partial sums (s += s + 4, s += s + 2, s += s + 1), and lane 0
//   forms the rows: d a = -M_xx / 2, d b = -M_xy, d c = -M_yy / 2, d xg =
//   -(a M_x + b M_y), d yg = -(c M_y + b M_x). Word (j, th) lies in bank (8
//   j + th) mod 32.
// A sum that starts from +0.0 is never -0.0, so skipping a pair adds
// exactly what adding its +0 terms would. No atomics: each instance
// belongs to one tile, whose block writes its column once. The plain
// version (ops/tile_render.py:composite_backward_torch, _pixel_sum) adds
// the same terms in the same order, zeros for the skipped pairs, and the
// library is built with -fmad=false, so the two agree bit for bit.
// The power-floor skip of B3, a register prefetch of the next chunk's
// rows, a walk split into evaluation and recurrence passes and a walk
// that stops at each warp's largest n_contrib measured no faster here and
// are left out (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "composite_cull.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels per tile = threads per block
constexpr int kWarps = kPix / 32;
constexpr int kChunk = 32;            // instances per chunk
constexpr int kSplit = kPix / kChunk; // threads per instance in phase B
static_assert(kSplit == 8, "phase B gathers ballot bits 8 apart");
constexpr int kStride = kPix + kSplit;  // padded row of the s_gd, s_w tiles
constexpr int kRows = 9;              // gradient rows (ROW_A .. ROW_B2)
constexpr int kOutRows = 16;          // rows of d_pack
constexpr int kRec = 12;              // floats per instance record
constexpr unsigned kFull = 0xffffffffu;
// gradient rows, and the first five sums of phase B: the moments of dpow
enum Row { kA, kB, kC, kXg, kYg, kOp };
enum Moment { kMx, kMy, kMxx, kMyy, kMxy };
constexpr size_t kDynSmem = 2 * kChunk * kStride * sizeof(float);

// pack row -> record slot. Record: {xg, yg, a, b}, {c, op, unused, block
// mask bits}, {r, g, b, unused}.
__constant__ int kSlot[kRows] = {2, 3, 4, 0, 1, 5, 8, 9, 10};

__device__ __forceinline__ void zero_columns(float* __restrict__ d_pack,
                                             int64_t m, int64_t lo,
                                             int64_t hi, int64_t first,
                                             int64_t step) {
  for (int64_t col = lo + first; col < hi; col += step) {
#pragma unroll
    for (int r = 0; r < kOutRows; ++r) d_pack[r * m + col] = 0.0f;
  }
}

__global__ void __launch_bounds__(kPix) composite_bwd_kernel(
    const float* __restrict__ pack, int64_t m,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    int n_tiles, int n_fill, int toff, int grid_x,
    const float* __restrict__ tiles, const float* __restrict__ g_tiles,
    float* __restrict__ d_pack) {
  extern __shared__ float dyn[];
  float* s_gd = dyn;                      // [kChunk][kStride]
  float* s_w = dyn + kChunk * kStride;    // [kChunk][kStride]
  __shared__ __align__(16) float s_rec[kChunk][kRec];
  __shared__ unsigned s_ballot[kChunk][kWarps];
  __shared__ float s_g[3][kPix];
  __shared__ float s_pc[2][kPix];       // pixel coordinates px, py
  __shared__ float s_sum[kRows][kChunk];
  __shared__ int warp_last[kWarps];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < n_fill) {
    zero_columns(d_pack, m, ends[n_tiles - 1], m,
                 (int64_t)blockIdx.x * kPix + tid, (int64_t)n_fill * kPix);
    return;
  }
  const int t = blockIdx.x - n_fill;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pix = rain_cull::pixel_of(tid);  // warp w: an 8x4 pixel block
  const int gt = t + toff;
  const int tx0 = (gt % grid_x) * kTile;
  const int ty0 = (gt / grid_x) * kTile;
  const float px = (float)(tx0 + pix % kTile);
  const float py = (float)(ty0 + pix / kTile);
  const int64_t start = starts[t];
  const int64_t end = ends[t];
  // the constants as f32 roundings of the reference's double literals
  const float alpha_min = (float)(1.0 / 255.0);
  const float alpha_clamp = (float)0.99;

  const float* o = tiles + ((int64_t)t * kPix + pix) * 8;
  const float* gp = g_tiles + ((int64_t)t * kPix + pix) * 8;
  const float g_r = gp[0], g_g = gp[1], g_b = gp[2];
  s_g[0][tid] = g_r;
  s_pc[0][tid] = px;
  s_pc[1][tid] = py;
  s_g[1][tid] = g_g;
  s_g[2][tid] = g_b;
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

  const int j_b = tid / kSplit;         // phase B: instance of this thread
  const int s_b = tid % kSplit;         // phase B: its pixel offset
  for (int base = 0; base < n_walk; base += kChunk) {
    const int cnt = min(kChunk, n_walk - base);
    __syncthreads();  // the previous chunk is reduced and written out
    if (tid < cnt) {
      float* q = s_rec[tid];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        q[kSlot[r]] = pack[r * m + start + base + tid];
      q[7] = __uint_as_float(rain_cull::block_mask(
          q[2], q[3], q[4], q[0], q[1],
          rain_cull::power_floor(q[5], alpha_min), tx0, ty0));
    }
    __syncthreads();

    // phase A: the walk. The warp visits, in order, the instances that can
    // reach its block.
    const bool reach =
        lane < cnt && ((__float_as_uint(s_rec[lane][7]) >> warp) & 1u);
    unsigned list = __ballot_sync(kFull, reach);
    if (lane < cnt) s_ballot[lane][warp] = 0u;
    __syncwarp();
    while (list != 0u) {
      const int j = __ffs(list) - 1;
      list &= list - 1u;
      bool active = false;
      if (base + j < last) {
        const float4 q0 = reinterpret_cast<const float4*>(s_rec[j])[0];
        const float4 q1 = reinterpret_cast<const float4*>(s_rec[j])[1];
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                            q0.w * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha = fminf(q1.y * G, alpha_clamp);
          if (alpha >= alpha_min) {
            active = true;
            const float4 q2 = reinterpret_cast<const float4*>(s_rec[j])[2];
            const float cgd = g_r * q2.x + g_g * q2.y + g_b * q2.z;
            const float om = 1.0f - alpha;
            const float w = alpha * T;
            rest = rest - w * cgd;
            const float dalpha = T * cgd - (rest + bg) / om;
            T = T * om;
            s_gd[j * kStride + tid] = dalpha * G;
            s_w[j * kStride + tid] = w;
          }
        }
      }
      const unsigned ballot = __ballot_sync(kFull, active);
      if (lane == 0) s_ballot[j][warp] = ballot;
    }
    __syncthreads();

    // phase B: the reduction, over the composited pixels only
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.0f;
    if (j_b < cnt) {
      const float xg = s_rec[j_b][0], yg = s_rec[j_b][1];
      const float op = s_rec[j_b][5];
      const float* gd_row = s_gd + j_b * kStride;
      const float* w_row = s_w + j_b * kStride;
      // bit i: thread s_b + 8 i composited instance j_b. Warp g's word
      // holds threads 32 g + 8 u + s_b at bits 8 u + s_b; the product
      // gathers those four bits (u = 0..3) into bits 28..31 in order.
      unsigned sel = 0u;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) {
        const unsigned bits = (s_ballot[j_b][g] >> s_b) & 0x01010101u;
        sel |= ((bits * 0x10204080u) >> 28) << (4 * g);
      }
      while (sel != 0u) {
        const int th = s_b + kSplit * (__ffs(sel) - 1);
        sel &= sel - 1u;
        const float gd = gd_row[th];
        const float w = w_row[th];
        const float dx = xg - s_pc[0][th];
        const float dy = yg - s_pc[1][th];
        const float dpow = gd * op;
        const float ex = dpow * dx, ey = dpow * dy;
        acc[kMx] = acc[kMx] + ex;
        acc[kMy] = acc[kMy] + ey;
        acc[kMxx] = acc[kMxx] + ex * dx;
        acc[kMyy] = acc[kMyy] + ey * dy;
        acc[kMxy] = acc[kMxy] + ex * dy;
        acc[5] = acc[5] + gd;
        acc[6] = acc[6] + w * s_g[0][th];
        acc[7] = acc[7] + w * s_g[1][th];
        acc[8] = acc[8] + w * s_g[2][th];
      }
    }
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc[q] = acc[q] + __shfl_down_sync(kFull, acc[q], off);
    }
    if (s_b == 0 && j_b < cnt) {
      // the geometric gradients from the moments
      const float a = s_rec[j_b][2], b = s_rec[j_b][3], cc = s_rec[j_b][4];
      s_sum[kA][j_b] = -0.5f * acc[kMxx];
      s_sum[kB][j_b] = -acc[kMxy];
      s_sum[kC][j_b] = -0.5f * acc[kMyy];
      s_sum[kXg][j_b] = -(a * acc[kMx] + b * acc[kMy]);
      s_sum[kYg][j_b] = -(cc * acc[kMy] + b * acc[kMx]);
#pragma unroll
      for (int q = kOp; q < kRows; ++q) s_sum[q][j_b] = acc[q];
    }
    __syncthreads();
    for (int idx = tid; idx < kOutRows * cnt; idx += kPix) {
      const int r = idx / cnt;
      const int j = idx - r * cnt;
      d_pack[r * m + start + base + j] = r < kRows ? s_sum[r][j] : 0.0f;
    }
  }

  // the columns of the range past the walk, the gap up to the next range
  // and, for tile 0, the columns before its range
  const int64_t next = t + 1 < n_tiles ? (int64_t)starts[t + 1] : end;
  const int64_t hi = next > end ? next : end;
  zero_columns(d_pack, m, start + n_walk, hi, tid, kPix);
  if (t == 0) zero_columns(d_pack, m, 0, start, tid, kPix);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. Writes all of d_pack [16, m], so it
// may be uninitialised.
extern "C" int rain_composite_backward(int device, void* stream,
                                       const void* pack, int64_t m,
                                       const void* starts, const void* ends,
                                       int n_tiles, int toff, int grid_x,
                                       const void* tiles, const void* g_tiles,
                                       void* d_pack) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) {
    return (int)cudaMemsetAsync(d_pack, 0, (size_t)kOutRows * m * sizeof(float),
                                (cudaStream_t)stream);
  }
  err = cudaFuncSetAttribute(composite_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDynSmem);
  if (err != cudaSuccess) return (int)err;
  // blocks that zero the columns past the last range, ~8k columns each
  const int n_fill = (int)std::min<int64_t>((m + 8191) / 8192, 256);
  composite_bwd_kernel<<<n_fill + n_tiles, kPix, kDynSmem,
                         (cudaStream_t)stream>>>(
      (const float*)pack, m, (const int32_t*)starts, (const int32_t*)ends,
      n_tiles, n_fill, toff, grid_x, (const float*)tiles,
      (const float*)g_tiles, (float*)d_pack);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel (cudaOccupancy...), into *blocks.
extern "C" int rain_composite_backward_occupancy(int device, void* stream,
                                                 void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(composite_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDynSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, composite_bwd_kernel, kPix, kDynSmem);
}
