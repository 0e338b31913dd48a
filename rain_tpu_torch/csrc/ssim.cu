// SSIM map: the forward kernel (SF) and its vector-Jacobian product (SB).
//
// Replaces no Pallas kernel: rain_tpu left the loss to XLA, which fused it
// (rain_tpu/ops/losses.py:ssim_map). Its plain version is
// ops/losses.py:ssim_map_plain, which stacks the five moment images, pads
// them and blurs them with 11 shifted slices along x and then along y;
// PyTorch runs that, with autograd's backward, as some 230 element-wise
// kernels over the image, each a pass over the 15-channel stack. Here the
// blur runs separably in shared memory, as in the fused SSIM of Mallick et
// al., "Taming 3DGS" (2024).
//
// Contract. Planes are the N*C (image, channel) planes of contiguous f32
// [N, C, H, W] images, zero outside the plane (SAME padding); the window
// is 11 taps g (ops/losses.py:_gaussian_window), its 2-D form g g^T.
// SF reads img1 and img2 and writes, for every pixel, the SSIM map and
// the three partials of the map that the backward needs: dm/dmu1 (with
// the blurred second moments held), dm/dsigma1^2 and dm/dsigma12. SB reads d_map, the three partials, img1 and img2 and
// writes d_img1 = B(a) + 2 img1 B(b) + img2 B(c), with a, b, c the products
// of d_map and the three partials and B the blur: with zero padding and
// symmetric taps, the blur's adjoint is the blur. Every output element is
// written once; no atomics, no reduction across threads, so both are
// bitwise reproducible.
//
// Rounding. SF forms the products before the blur, blurs along x and then
// along y, sums the taps k = 0..10 from the first product (no zero start),
// and evaluates the map in ssim_map_plain's order, so under the build's
// -fmad=false its map equals the plain version's bit for bit. SB's sums
// round in another order than autograd's; its gradient agrees to f32
// rounding.
//
// Bound on the H100: bytes. SF reads 2 floats a pixel and writes 4 (the
// map and the partials), SB reads 6 and writes 1: 13 floats a pixel over
// both, 170 MB for a 3 x 840 x 1297 image pair, 0.051 ms at 3.35 TB/s; the
// ~375 f32 operations a pixel take 0.018 ms at 67 T/s. Design: a block
// covers a 32 x 16 output tile of one plane. It stages the tile and a
// 5-pixel halo of its inputs in shared memory (each input element is read
// from memory by the ~2.1 blocks whose halo holds it, mostly from L2),
// blurs the rows of the halo'd tile along x into shared memory, then each
// thread blurs its column along y in registers: 11 taps a pass, against
// the 121 of the 2-D window. Consecutive threads read consecutive words in
// both passes, so no shared-memory bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;
constexpr int kPad = kWin / 2;
constexpr int kTW = 32;                 // output tile width: threadIdx.x
constexpr int kTH = 16;                 // output tile height: threadIdx.y
constexpr int kHW = kTW + 2 * kPad;     // the halo'd tile: 42 x 26
constexpr int kHH = kTH + 2 * kPad;
constexpr int kThreads = kTW * kTH;

// the taps and the map's constants, by value in the kernel's parameters
struct Taps {
  float g[kWin];
  float c1, c2;
};

// Blurs the rows of the halo'd tile along x: out[j][r][c] = sum_k g[k]
// in[j][r][c + k], for the kHH x kTW outputs, in tap order.
template <int J>
__device__ __forceinline__ void blur_x(float (*in)[kHH][kHW],
                                       float (*out)[kHH][kTW],
                                       const Taps& t, int tid) {
  for (int i = tid; i < kHH * kTW; i += kThreads) {
    const int r = i / kTW, c = i % kTW;
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = t.g[0] * in[j][r][c];
#pragma unroll
    for (int k = 1; k < kWin; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = acc[j] + t.g[k] * in[j][r][c + k];
#pragma unroll
    for (int j = 0; j < J; ++j) out[j][r][c] = acc[j];
  }
}

// Blurs column tx of the x-blurred tile along y for output row ty.
template <int J>
__device__ __forceinline__ void blur_y(float (*in)[kHH][kTW],
                                       const Taps& t, int tx, int ty,
                                       float* acc) {
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = t.g[0] * in[j][ty][tx];
#pragma unroll
  for (int k = 1; k < kWin; ++k)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = acc[j] + t.g[k] * in[j][ty + k][tx];
}

__global__ void __launch_bounds__(kThreads) ssim_fwd_kernel(
    int h, int w, const float* __restrict__ img1,
    const float* __restrict__ img2, Taps t, float* __restrict__ map,
    float* __restrict__ d_mu1, float* __restrict__ d_s1,
    float* __restrict__ d_s12) {
  // the five moment inputs x, y, x*x, y*y, x*y of the halo'd tile, then
  // their x blur
  __shared__ float s_in[5][kHH][kHW];
  __shared__ float s_x[5][kHH][kTW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW - kPad, y0 = blockIdx.y * kTH - kPad;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  for (int i = tid; i < kHH * kHW; i += kThreads) {
    const int r = i / kHW, c = i % kHW;
    const int y = y0 + r, x = x0 + c;
    float u = 0.0f, v = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      u = img1[plane + (int64_t)y * w + x];
      v = img2[plane + (int64_t)y * w + x];
    }
    s_in[0][r][c] = u;
    s_in[1][r][c] = v;
    s_in[2][r][c] = u * u;
    s_in[3][r][c] = v * v;
    s_in[4][r][c] = u * v;
  }
  __syncthreads();
  blur_x<5>(s_in, s_x, t, tid);
  __syncthreads();
  const int y = blockIdx.y * kTH + ty, x = blockIdx.x * kTW + tx;
  if (y >= h || x >= w) return;
  float o[5];
  blur_y<5>(s_x, t, tx, ty, o);

  // ssim_map_plain's formula, in its order
  const float mu1 = o[0], mu2 = o[1];
  const float mu1_sq = mu1 * mu1;
  const float mu2_sq = mu2 * mu2;
  const float mu1_mu2 = mu1 * mu2;
  const float sigma1_sq = o[2] - mu1_sq;
  const float sigma2_sq = o[3] - mu2_sq;
  const float sigma12 = o[4] - mu1_mu2;
  const float num_l = 2.0f * mu1_mu2 + t.c1;
  const float num_c = 2.0f * sigma12 + t.c2;
  const float den_l = mu1_sq + mu2_sq + t.c1;
  const float den_c = sigma1_sq + sigma2_sq + t.c2;
  const float m = (num_l * num_c) / (den_l * den_c);
  const int64_t at = plane + (int64_t)y * w + x;
  map[at] = m;
  // m = num_l num_c / (den_l den_c); sigma1^2 and sigma12 hold -mu1^2 and
  // -mu1 mu2, so with the blurred moments held dm/dmu1 takes
  // 2 mu2 (num_c - num_l) / den + 2 mu1 m (den_l - den_c) / den
  const float den = den_l * den_c;
  d_mu1[at] = 2.0f * (mu2 * (num_c - num_l) + mu1 * m * (den_l - den_c)) /
              den;
  d_s1[at] = -m / den_c;
  d_s12[at] = 2.0f * num_l / den;
}

__global__ void __launch_bounds__(kThreads) ssim_bwd_kernel(
    int h, int w, const float* __restrict__ img1,
    const float* __restrict__ img2, const float* __restrict__ d_map,
    const float* __restrict__ d_mu1, const float* __restrict__ d_s1,
    const float* __restrict__ d_s12, Taps t, float* __restrict__ d_img1) {
  // a, b, c = d_map times the three partials on the halo'd tile, then
  // their x blur
  __shared__ float s_in[3][kHH][kHW];
  __shared__ float s_x[3][kHH][kTW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW - kPad, y0 = blockIdx.y * kTH - kPad;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  for (int i = tid; i < kHH * kHW; i += kThreads) {
    const int r = i / kHW, c = i % kHW;
    const int y = y0 + r, x = x0 + c;
    float a = 0.0f, b = 0.0f, cc = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const int64_t at = plane + (int64_t)y * w + x;
      const float d = d_map[at];
      a = d * d_mu1[at];
      b = d * d_s1[at];
      cc = d * d_s12[at];
    }
    s_in[0][r][c] = a;
    s_in[1][r][c] = b;
    s_in[2][r][c] = cc;
  }
  __syncthreads();
  blur_x<3>(s_in, s_x, t, tid);
  __syncthreads();
  const int y = blockIdx.y * kTH + ty, x = blockIdx.x * kTW + tx;
  if (y >= h || x >= w) return;
  float o[3];
  blur_y<3>(s_x, t, tx, ty, o);
  const int64_t at = plane + (int64_t)y * w + x;
  d_img1[at] = o[0] + 2.0f * img1[at] * o[1] + img2[at] * o[2];
}

Taps make_taps(const float* g, float c1, float c2) {
  Taps t;
  for (int k = 0; k < kWin; ++k) t.g[k] = g[k];
  t.c1 = c1;
  t.c2 = c2;
  return t;
}

}  // namespace

// SF on `planes` planes of h x w. `taps` is a host array of the 11 taps.
// Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (0 on success). ops/losses.py checks the
// shapes (planes, the grid's rows below 65,536).
extern "C" int rain_ssim_forward(int device, void* stream, int planes, int h,
                                 int w, const void* img1, const void* img2,
                                 const void* taps, float c1, float c2,
                                 void* map, void* d_mu1, void* d_s1,
                                 void* d_s12) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (planes == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, planes);
  ssim_fwd_kernel<<<grid, dim3(kTW, kTH), 0, (cudaStream_t)stream>>>(
      h, w, (const float*)img1, (const float*)img2,
      make_taps((const float*)taps, c1, c2), (float*)map, (float*)d_mu1,
      (float*)d_s1, (float*)d_s12);
  return (int)cudaGetLastError();
}

// SB: d_img1 from d_map and SF's partials (contract as rain_ssim_forward).
extern "C" int rain_ssim_backward(int device, void* stream, int planes, int h,
                                  int w, const void* img1, const void* img2,
                                  const void* d_map, const void* d_mu1,
                                  const void* d_s1, const void* d_s12,
                                  const void* taps, void* d_img1) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (planes == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, planes);
  ssim_bwd_kernel<<<grid, dim3(kTW, kTH), 0, (cudaStream_t)stream>>>(
      h, w, (const float*)img1, (const float*)img2, (const float*)d_map,
      (const float*)d_mu1, (const float*)d_s1, (const float*)d_s12,
      make_taps((const float*)taps, 0.0f, 0.0f), (float*)d_img1);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of SF and of SB, into blocks[0] and blocks[1].
extern "C" int rain_ssim_occupancy(int device, void* stream, void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor((int*)blocks,
                                                      ssim_fwd_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks + 1, ssim_bwd_kernel, kThreads, 0);
}
