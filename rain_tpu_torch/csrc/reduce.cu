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
// one owner.
//
// Bound on the H100: bytes. Each instance's rows are read once and each
// Gaussian's rows written once, with one add per instance and row.
//
// Design. One thread per (row, Gaussian), blockIdx.y = row. The thread sums
// its own segment in order, so the result is the same on every run and
// equals the plain PyTorch version bit for bit; no atomics. Neighbouring
// threads own neighbouring segments, so a warp's reads fall on a few
// consecutive cache lines and its writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float* __restrict__ d, int64_t m, const int64_t* __restrict__ exc,
    const int32_t* __restrict__ tiles, int64_t n, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int64_t r = blockIdx.y;
  const float* row = d + r * m;
  const int64_t begin = exc[g];
  const int64_t stop = begin + (int64_t)tiles[g];
  const int64_t end = stop < m ? stop : m;
  float s = 0.0f;
  for (int64_t i = begin; i < end; ++i) s = s + row[i];
  out[r * n + g] = s;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int rain_reduce_instances(int device, void* stream, const void* d,
                                     int rows, int64_t m, const void* exc,
                                     const void* tiles, int64_t n,
                                     void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || rows == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  reduce_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const float*)d, m, (const int64_t*)exc, (const int32_t*)tiles, n,
      (float*)out);
  return (int)cudaGetLastError();
}
