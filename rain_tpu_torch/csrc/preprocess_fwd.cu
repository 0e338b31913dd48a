// Preprocess forward: the raw parameters of every Gaussian to its screen
// quantities, one thread per Gaussian.
//
// Replaces no Pallas kernel: rain_tpu left preprocess to XLA, which fused
// it (rain_tpu/model/gaussians.py:activate, rain_tpu/ops/projection.py,
// rain_tpu/ops/sh.py under jit). Its plain version is
// ops/preprocess.py:preprocess_torch (gaussians.activate, then
// projection.preprocess), which PyTorch runs as some 420 element-wise
// kernels, each a pass over N rows; this kernel is the reference
// rasterizer's preprocessCUDA (cuda_rasterizer/forward.cu:152-246) in the
// port's parameterisation: the activation (exp, the quaternion's norm, the
// sigmoid) and the SH concatenation happen in registers.
//
// Contract. Gaussian g reads xyz[g] (3), features_dc[g] (3),
// features_rest[g] (rest x 3, of which the degree's first (D+1)^2 - 1
// rows), scaling[g] (3), rotation[g] (4), opacity[g] (1) and alive[g], and
// the per-call values from device memory (preprocess.cuh:CamPtrs), and
// writes xy[g] (2), depth[g], conic[g] (3), rgb[g] (3), opacity_out[g],
// radii[g], rect_min[g] (2), rect_wh[g] (2) and tiles[g], every element
// (projection.Preprocessed). The arithmetic is that of the plain version
// on the card (preprocess.cuh), so every output equals it bit for bit.
//
// Bound on the H100: bytes. 59 floats and a byte in, 16 words out per
// Gaussian: 1.26 GB at 4,194,304 Gaussians, 0.38 ms at 3.35 TB/s; the
// ~250 f32 operations a Gaussian take 0.016 ms at 67 T/s. Design: each
// input row is read once and each output written once, with no atomics.
// The 45-float rows of features_rest are the stream that matters: a
// block's 128 rows are one contiguous span, which the block stages into
// shared memory with 16-byte loads, each thread then reading its own row
// there (a row stride of 45 words is odd, so a warp's reads hit 32
// banks). The short rows (xyz, scaling, rotation, ...) are read by each
// thread, a warp's loads covering one contiguous span.

#include "preprocess.cuh"

namespace {

using namespace rain_prep;

struct Rect {
  float x0, y0;
  int w, h;
};

// projection.preprocess's make_rect: the tile rect of a footprint of
// radii (rx, ry) about (x, y), clamped to the grid
__device__ __forceinline__ Rect make_rect(float x, float y, float rx,
                                          float ry, float gx, float gy) {
  Rect r;
  r.x0 = clampf(floorf((x - rx) * kInvTile), 0.0f, gx);
  r.y0 = clampf(floorf((y - ry) * kInvTile), 0.0f, gy);
  const float x1 = clampf(floorf((x + rx + kTile - 1.0f) * kInvTile), 0.0f,
                          gx);
  const float y1 = clampf(floorf((y + ry + kTile - 1.0f) * kInvTile), 0.0f,
                          gy);
  r.w = (int)(x1 - r.x0);
  r.h = (int)(y1 - r.y0);
  return r;
}

template <int D>
__global__ void __launch_bounds__(kBlock) preprocess_fwd_kernel(
    int n, const float* __restrict__ xyz, const float* __restrict__ fdc,
    const float* __restrict__ frest, int rest,
    const float* __restrict__ scaling, const float* __restrict__ rotation,
    const float* __restrict__ opacity, const bool* __restrict__ alive,
    CamPtrs cp, float grid_x, float grid_y, bool tight,
    float* __restrict__ xy, float* __restrict__ depth,
    float* __restrict__ conic, float* __restrict__ rgb,
    float* __restrict__ op_out, int32_t* __restrict__ radii,
    int32_t* __restrict__ rect_min, int32_t* __restrict__ rect_wh,
    int32_t* __restrict__ tiles) {
  extern __shared__ __align__(16) float s_rest[];
  __shared__ Cam cam;
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * kBlock;
  const int g = g0 + t;
  const int stride = rest * 3;
  if (t == 0) load_cam(cp, cam);
  if (D > 0)
    stage_in(s_rest, frest + (int64_t)g0 * stride,
             min(kBlock, n - g0) * stride);
  __syncthreads();
  if (g >= n) return;

  float x[3], sc[3], rot[4];
  for (int i = 0; i < 3; ++i) {
    x[i] = xyz[3 * g + i];
    sc[i] = scaling[3 * g + i];
  }
  for (int i = 0; i < 4; ++i) rot[i] = rotation[4 * g + i];
  const float op = sigmoid(opacity[g]);
  Geo geo;
  geometry(cam, x, sc, rot, geo);

  // the conic, the radius and the screen position
  const float mid = 0.5f * (geo.a + geo.c);
  const float lambda1 =
      mid + sqrtf(clamp_min(mid * mid - geo.det, 0.1f));
  const float radius = ceilf(3.0f * sqrtf(lambda1));
  const float px = ((geo.ph[0] * geo.pw + 1.0f) * cam.w - 1.0f) * 0.5f;
  const float py = ((geo.ph[1] * geo.pw + 1.0f) * cam.h - 1.0f) * 0.5f;

  const Rect ref = make_rect(px, py, radius, radius, grid_x, grid_y);
  const bool visible = alive[g] && geo.in_front && geo.det_ok &&
                       ref.w * ref.h > 0;
  float r_x = radius, r_y = radius;
  bool reachable = true;
  if (tight) {
    // alpha >= 1/255 only inside q <= lim = 2 ln(255 op)
    const float lim = clamp_min(
        2.0f * logf(clamp_min(255.0f * op, 1e-6f)) + 0.02f, 0.0f);
    r_x = min_nan(radius, ceilf(sqrtf(lim * geo.a)) + 1.0f);
    r_y = min_nan(radius, ceilf(sqrtf(lim * geo.c)) + 1.0f);
    reachable = op >= (float)(1.0 / 255.0);
  }
  const Rect rect = make_rect(px, py, r_x, r_y, grid_x, grid_y);

  // the colour (sh.sh_to_rgb)
  Dir dir;
  direction(cam, x, dir);
  constexpr int K = (D + 1) * (D + 1);
  float b[K];
  sh_basis<D>(dir.u, b);
  const float* row = s_rest + t * stride;
  for (int ch = 0; ch < 3; ++ch) {
    float acc = b[0] * fdc[3 * g + ch];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + b[k] * row[3 * (k - 1) + ch];
    rgb[3 * g + ch] = clamp_min(acc + 0.5f, 0.0f);
  }

  xy[2 * g] = px;
  xy[2 * g + 1] = py;
  depth[g] = geo.pv[2];
  conic[3 * g] = geo.c * geo.det_inv;
  conic[3 * g + 1] = -geo.b * geo.det_inv;
  conic[3 * g + 2] = geo.a * geo.det_inv;
  op_out[g] = op;
  radii[g] = visible ? (int)radius : 0;
  rect_min[2 * g] = (int)rect.x0;
  rect_min[2 * g + 1] = (int)rect.y0;
  rect_wh[2 * g] = rect.w;
  rect_wh[2 * g + 1] = rect.h;
  tiles[g] = visible && reachable ? rect.w * rect.h : 0;
}

template <int D>
cudaError_t launch(cudaStream_t stream, int n, const float* xyz,
                   const float* fdc, const float* frest, int rest,
                   const float* scaling, const float* rotation,
                   const float* opacity, const bool* alive,
                   const CamPtrs& cp, int grid_x, int grid_y, bool tight,
                   float* xy, float* depth, float* conic, float* rgb,
                   float* op_out, int32_t* radii, int32_t* rect_min,
                   int32_t* rect_wh, int32_t* tiles) {
  const size_t smem = D > 0 ? sizeof(float) * kBlock * rest * 3 : 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  preprocess_fwd_kernel<D><<<blocks, kBlock, smem, stream>>>(
      n, xyz, fdc, frest, rest, scaling, rotation, opacity, alive, cp,
      (float)grid_x, (float)grid_y, tight, xy, depth, conic, rgb, op_out,
      radii, rect_min, rect_wh, tiles);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. degree in 0..4, and rest >=
// (degree + 1)^2 - 1 (ops/preprocess.py checks both).
extern "C" int rain_preprocess_forward(
    int device, void* stream, int n, int degree, const void* xyz,
    const void* fdc, const void* frest, int rest, const void* scaling,
    const void* rotation, const void* opacity, const void* alive,
    const void* world_view, const void* full_proj, const void* center,
    const void* tanfovx, const void* tanfovy, const void* low_pass,
    const void* scale_modifier, const void* width, const void* height,
    int grid_x, int grid_y, int tight, void* xy, void* depth, void* conic,
    void* rgb, void* op_out, void* radii, void* rect_min, void* rect_wh,
    void* tiles) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const CamPtrs cp{(const float*)world_view, (const float*)full_proj,
                   (const float*)center,     (const float*)tanfovx,
                   (const float*)tanfovy,    (const float*)low_pass,
                   (const float*)scale_modifier, (const int32_t*)width,
                   (const int32_t*)height};
  cudaStream_t s = (cudaStream_t)stream;
#define RAIN_PREP_FWD(DEG)                                                  \
  launch<DEG>(s, n, (const float*)xyz, (const float*)fdc,                  \
              (const float*)frest, rest, (const float*)scaling,            \
              (const float*)rotation, (const float*)opacity,               \
              (const bool*)alive, cp, grid_x, grid_y, tight != 0,          \
              (float*)xy, (float*)depth, (float*)conic, (float*)rgb,       \
              (float*)op_out, (int32_t*)radii, (int32_t*)rect_min,         \
              (int32_t*)rect_wh, (int32_t*)tiles)
  switch (degree) {
    case 0: return (int)RAIN_PREP_FWD(0);
    case 1: return (int)RAIN_PREP_FWD(1);
    case 2: return (int)RAIN_PREP_FWD(2);
    case 3: return (int)RAIN_PREP_FWD(3);
    case 4: return (int)RAIN_PREP_FWD(4);
  }
#undef RAIN_PREP_FWD
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the degree-3 kernel at rest = 15
// (cudaOccupancy...), into *blocks.
extern "C" int rain_preprocess_forward_occupancy(int device, void* stream,
                                                 void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, preprocess_fwd_kernel<3>, kBlock,
      sizeof(float) * kBlock * 15 * 3);
}
