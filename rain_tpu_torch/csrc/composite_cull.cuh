// Conservative per-instance culling for the compositor kernels: B3
// (tile_render_fwd.cu) uses the power floor and the block mask, B4
// (tile_render_bwd.cu) the block mask. Both give warp w of a tile's block
// the 8x4 pixels x = 8 (w mod 2) + (lane mod 8), y = 4 (w / 2) + lane / 8
// (pixel_of below).
//
// A (pixel, instance) pair composites when its power, computed as
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = xg - px, dy = yg - py,
// is <= 0 and alpha = min(0.99, op e^power) >= 1/255. Both tests below are
// computed once per instance when it is loaded and only ever reject pairs
// that fail those rules under the kernels' own f32 arithmetic, so a kernel
// that uses them composites exactly the pairs its plain version does. The
// plain PyTorch copies are ops/tile_render.py:power_floor and block_mask;
// tests/test_torch_cull.py holds them to the rules on random and
// adversarial instances.
//
// power_floor(op) = ln(alpha_min / op) - kFloorMargin. A pair whose power
// lies below it has op e^power < alpha_min e^-0.001, far below alpha_min
// even after expf's and the product's roundings (a few ulps), so it is
// skipped without the exponential. op <= 0 or NaN gives NaN (no skip) or
// +inf (op = +0: every finite power skips; alpha would be 0).
//
// block_mask: bit w is set unless no pixel of warp w's 8x4 block, x in
// [tx0 + 8 (w mod 2), + 7] and y in [ty0 + 4 (w / 2), + 3], can reach
// power >= floor. The f32 power differs from the exact one by at most
// kGamma (|a| dx^2 + |c| dy^2 + 2 |b dx dy|) (kGamma = 1e-5 covers the
// seven roundings, ~4e-7), so every pair that can pass lies in
//   0.5 (a'' u^2 + c'' v^2 - 2 b'' u v) <= L,  u = |dx|, v = |dy|,
// with a'' = a (1 - 2 kGamma), c'' = c (1 - 2 kGamma), b'' = |b| (1 + 2
// kGamma) and L = -floor: |dy| <= sqrt(2 L a'' / det''), |dx| <= sqrt(2 L
// c'' / det''), det'' = a'' c'' - b''^2. The radii grow by 1 % and 0.05 px
// for the roundings of dx, dy, det'' and the square roots. An instance
// that is not a well-conditioned ellipse (a'' or c'' <= 0, det'' <= 1e-3
// a'' c'', or a non-finite radius) keeps every bit; one whose floor is
// above 0 keeps none (no pair with power <= 0 reaches it).

#pragma once

#include <cuda_runtime.h>

namespace rain_cull {

constexpr float kFloorMargin = 1e-3f;
constexpr float kGamma = 1e-5f;
constexpr float kGrow = 1.01f;
constexpr float kPad = 0.05f;
constexpr float kCond = 1e-3f;
constexpr float kHuge = 1e30f;

__device__ __forceinline__ float power_floor(float op, float alpha_min) {
  return logf(alpha_min / op) - kFloorMargin;
}

// The tile pixel (row-major index) of thread tid of a 256-thread block.
__device__ __forceinline__ int pixel_of(int tid) {
  const int w = tid >> 5, lane = tid & 31;
  return 16 * (4 * (w >> 1) + (lane >> 3)) + 8 * (w & 1) + (lane & 7);
}

__device__ __forceinline__ unsigned block_mask(float a, float b, float c,
                                               float xg, float yg,
                                               float floor, int tx0,
                                               int ty0) {
  const float L = -floor;
  if (L < 0.0f) return 0u;
  const float ap = a * (1.0f - 2.0f * kGamma);
  const float cp = c * (1.0f - 2.0f * kGamma);
  const float bp = fabsf(b) * (1.0f + 2.0f * kGamma);
  const float apcp = ap * cp;
  const float det = apcp - bp * bp;
  const float ry = sqrtf(2.0f * L * ap / det) * kGrow + kPad;
  const float rx = sqrtf(2.0f * L * cp / det) * kGrow + kPad;
  // written so that a NaN conic or floor keeps every bit (a NaN xg or yg
  // makes every power NaN, which never composites)
  if (!(ap > 0.0f && cp > 0.0f && det > kCond * apcp && ry < kHuge &&
        rx < kHuge))
    return 0xffu;
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const float x0 = (float)(tx0 + 8 * (w & 1));
    const float y0 = (float)(ty0 + 4 * (w >> 1));
    if (xg + rx >= x0 && xg - rx <= x0 + 7.0f && yg + ry >= y0 &&
        yg - ry <= y0 + 3.0f)
      mask |= 1u << w;
  }
  return mask;
}

}  // namespace rain_cull
