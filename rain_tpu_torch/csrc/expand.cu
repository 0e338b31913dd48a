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
// last.
//
// Bound on the H100: bytes. Each instance reads one 40-byte column and
// writes it plus an 8-byte key; there is no arithmetic to speak of.
//
// Design. One thread per instance, with a binary search over the inclusive
// offsets for its owner (the offsets are a few MB and stay in L2). Adjacent
// threads write adjacent columns of each row, so every store is coalesced,
// and neighbouring instances mostly share an owner, so the table reads are
// broadcasts. No atomics; the int64 key replaces the f32-carried integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) expand_kernel(
    const float* __restrict__ table, int64_t n,
    const int32_t* __restrict__ tiles, const int64_t* __restrict__ offs,
    const int32_t* __restrict__ rect_w, const int32_t* __restrict__ rect_base,
    int64_t m, int grid_x, int tile_offset, int n_tiles,
    float* __restrict__ out, int64_t* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const int64_t total = n > 0 ? offs[n - 1] : 0;
  if (i >= total) {
    for (int r = 0; r < kRows; ++r) out[r * m + i] = 0.0f;
    keys[i] = (int64_t)n_tiles << 32;
    return;
  }
  // owner g = #{g : offs[g] <= i}; offs[n - 1] = total > i bounds it by n-1
  int64_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (offs[mid] > i) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int64_t g = lo;
  const int64_t local = i - (offs[g] - tiles[g]);
  const int64_t w = max(rect_w[g], 1);
  const int64_t dy = local / w;
  const int64_t dx = local - dy * w;
  const int64_t tile = rect_base[g] + dy * grid_x + dx - tile_offset;
  keys[i] = (tile << 32) | g;
  for (int r = 0; r < kRows; ++r) out[r * m + i] = table[r * n + g];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int rain_expand_instances(
    int device, void* stream, const void* table, int64_t n, const void* tiles,
    const void* offs, const void* rect_w, const void* rect_base, int64_t m,
    int grid_x, int tile_offset, int n_tiles, void* out, void* keys) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  expand_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, n, (const int32_t*)tiles, (const int64_t*)offs,
      (const int32_t*)rect_w, (const int32_t*)rect_base, m, grid_x,
      tile_offset, n_tiles, (float*)out, (int64_t*)keys);
  return (int)cudaGetLastError();
}
