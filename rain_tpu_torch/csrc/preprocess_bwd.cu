// Preprocess backward: the cotangents of the screen quantities to the
// gradients of every Gaussian's raw parameters, one thread per Gaussian.
//
// Replaces no Pallas kernel: rain_tpu left preprocess to XLA, whose
// autodiff fused its backward. Its plain version is autograd through
// ops/preprocess.py:preprocess_torch, which PyTorch runs as some 770
// kernels at the main path's sizes: a pass over N rows for every edge of
// the graph, the adds that accumulate a leaf's gradient from its uses and
// the fills of the zeros they start from. This kernel is the reference
// rasterizer's preprocess backward (cuda_rasterizer/backward.cu:133-386)
// in the port's parameterisation, through the activation too.
//
// Contract. Gaussian g reads its raw parameters (as the forward does),
// the per-call values, and the cotangents d_xy[g] (2), d_depth[g],
// d_conic[g] (3), d_rgb[g] (3) and d_opacity[g] (each may be null, read as
// zero), and writes the gradients of xyz (3), features_dc (3),
// features_rest (rest x 3: zero past the degree's rows), scaling (3),
// rotation (4) and opacity (1), every element: the vector-Jacobian product
// of the forward (preprocess_fwd.cu), as autograd takes it through the
// plain version (preprocess.cuh). Nothing of the forward is kept: every
// intermediate is computed again from the raw parameters.
//
// Bound on the H100: bytes. 59 floats and 10 cotangents in, 59 floats out
// per Gaussian: 2.16 GB at 4,194,304 Gaussians, 0.65 ms at 3.35 TB/s (the
// ~700 f32 operations a Gaussian take 0.04 ms at 67 T/s). Design: as the
// forward's, each row read once and each gradient written once with no
// atomics; a block stages its features_rest span in shared memory, each
// thread reads its own row there and writes its gradient row over it, and
// the block stores the span back with 16-byte stores.

#include "preprocess.cuh"

namespace {

using namespace rain_prep;

__device__ __forceinline__ float read_or_zero(const float* p, int64_t i) {
  return p != nullptr ? p[i] : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(kBlock) preprocess_bwd_kernel(
    int n, const float* __restrict__ xyz, const float* __restrict__ fdc,
    const float* __restrict__ frest, int rest,
    const float* __restrict__ scaling, const float* __restrict__ rotation,
    const float* __restrict__ opacity, CamPtrs cp,
    const float* __restrict__ d_xy, const float* __restrict__ d_depth,
    const float* __restrict__ d_conic, const float* __restrict__ d_rgb,
    const float* __restrict__ d_op, float* __restrict__ g_xyz,
    float* __restrict__ g_fdc, float* __restrict__ g_frest,
    float* __restrict__ g_scaling, float* __restrict__ g_rot,
    float* __restrict__ g_op) {
  extern __shared__ __align__(16) float s_rest[];
  __shared__ Cam cam;
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * kBlock;
  const int g = g0 + t;
  const int stride = rest * 3;
  const int span = min(kBlock, n - g0) * stride;
  if (t == 0) load_cam(cp, cam);
  if (D > 0) stage_in(s_rest, frest + (int64_t)g0 * stride, span);
  __syncthreads();

  if (g < n) {
    float x[3], sc[3], rot[4];
    for (int i = 0; i < 3; ++i) {
      x[i] = xyz[3 * g + i];
      sc[i] = scaling[3 * g + i];
    }
    for (int i = 0; i < 4; ++i) rot[i] = rotation[4 * g + i];
    Geo geo;
    geometry(cam, x, sc, rot, geo);
    Dir dir;
    direction(cam, x, dir);

    // opacity: the sigmoid's backward, grad (1 - y) y
    const float op = sigmoid(opacity[g]);
    g_op[g] = read_or_zero(d_op, g) * (1.0f - op) * op;

    // colour: the clamp at 0 passes where rgb >= 0, then the basis
    constexpr int K = (D + 1) * (D + 1);
    float b[K];
    sh_basis<D>(dir.u, b);
    float* row = s_rest + t * stride;
    float ge[3];
    for (int ch = 0; ch < 3; ++ch) {
      float acc = b[0] * fdc[3 * g + ch];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + b[k] * row[3 * (k - 1) + ch];
      ge[ch] = acc + 0.5f >= 0.0f ? read_or_zero(d_rgb, 3 * g + ch) : 0.0f;
      g_fdc[3 * g + ch] = kC0 * ge[ch];
    }
    float e[K];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float* sh = row + 3 * (k - 1);
      e[k] = sh[0] * ge[0] + sh[1] * ge[1] + sh[2] * ge[2];
    }
    // the row's gradient over the row, zero past the degree
#pragma unroll
    for (int k = 1; k < K; ++k)
      for (int ch = 0; ch < 3; ++ch) row[3 * (k - 1) + ch] = b[k] * ge[ch];
    for (int i = 3 * (K - 1); i < stride; ++i) row[i] = 0.0f;
    float gu[3] = {0.0f, 0.0f, 0.0f};
    sh_basis_vjp<D>(dir.u, e, gu);
    float gx[3] = {0.0f, 0.0f, 0.0f};
    if (dir.ok) {
      // u = d / |d|: d gu/|d| - d (gu . d) / |d|^3
      const float ginv = gu[0] * dir.d[0] + gu[1] * dir.d[1] +
                         gu[2] * dir.d[2];
      const float gsq = ginv * -0.5f * dir.inv * dir.inv * dir.inv;
      for (int i = 0; i < 3; ++i)
        gx[i] = gu[i] * dir.inv + 2.0f * dir.d[i] * gsq;
    }

    // the conic (c, -b, a) / det
    const float ga = read_or_zero(d_conic, 3 * g);
    const float gb = read_or_zero(d_conic, 3 * g + 1);
    const float gc = read_or_zero(d_conic, 3 * g + 2);
    float g_a = gc * geo.det_inv;
    float g_b = -(gb * geo.det_inv);
    float g_c = ga * geo.det_inv;
    if (geo.det_ok) {
      const float g_di = ga * geo.c - gb * geo.b + gc * geo.a;
      const float g_det = -g_di * geo.det_inv * geo.det_inv;
      g_a += g_det * geo.c;
      g_c += g_det * geo.a;
      g_b += -2.0f * geo.b * g_det;
    }

    // cov = (m0 C m0, m1 C m0, m1 C m1) with v = C m
    const float* m0 = geo.m;
    const float* m1 = geo.m + 3;
    const float* v0 = geo.v;
    const float* v1 = geo.v + 3;
    float gv0[3], gv1[3], gm0[3], gm1[3];
    for (int j = 0; j < 3; ++j) {
      gv0[j] = g_a * m0[j] + g_b * m1[j];
      gv1[j] = g_c * m1[j];
      gm0[j] = g_a * v0[j];
      gm1[j] = g_b * v0[j] + g_c * v1[j];
    }
    const float* Cp = geo.C;
    const float Cf[9] = {Cp[0], Cp[1], Cp[2], Cp[1], Cp[3],
                         Cp[4], Cp[2], Cp[4], Cp[5]};
    for (int j = 0; j < 3; ++j) {
      gm0[j] += gv0[0] * Cf[j] + gv0[1] * Cf[3 + j] + gv0[2] * Cf[6 + j];
      gm1[j] += gv1[0] * Cf[j] + gv1[1] * Cf[3 + j] + gv1[2] * Cf[6 + j];
    }
    // G_ij = gv0_i m0_j + gv1_i m1_j, folded onto the packed entries
    float G[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) G[3 * i + j] = gv0[i] * m0[j] + gv1[i] * m1[j];
    const float gC[6] = {G[0], G[1] + G[3], G[2] + G[6],
                         G[4], G[5] + G[7], G[8]};

    // m = J W: m0k = j00 W0k + j02 W2k, m1k = j11 W1k + j12 W2k
    const float* W = cam.wv;
    float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
    for (int k = 0; k < 3; ++k) {
      g_j00 += gm0[k] * W[k];
      g_j02 += gm0[k] * W[8 + k];
      g_j11 += gm1[k] * W[4 + k];
      g_j12 += gm1[k] * W[8 + k];
    }
    // J from 1/tz and the clamped tx, ty
    const float g_tx = -(g_j02 * geo.inv_tz2) * cam.fx;
    const float g_ty = -(g_j12 * geo.inv_tz2) * cam.fy;
    const float g_inv_tz2 = g_j02 * -(cam.fx * geo.tx) +
                            g_j12 * -(cam.fy * geo.ty);
    const float g_inv_tz = g_j00 * cam.fx + g_j11 * cam.fy +
                           g_inv_tz2 * 2.0f * geo.inv_tz;
    float g_tz = -g_inv_tz * geo.inv_tz * geo.inv_tz;
    // tx = clamp(px / tz, -lim, lim) tz
    const float cx = clampf(geo.rx, -cam.limx, cam.limx);
    const float cy = clampf(geo.ry, -cam.limy, cam.limy);
    g_tz += g_tx * cx + g_ty * cy;
    const float g_rx =
        geo.rx >= -cam.limx && geo.rx <= cam.limx ? g_tx * geo.tz : 0.0f;
    const float g_ry =
        geo.ry >= -cam.limy && geo.ry <= cam.limy ? g_ty * geo.tz : 0.0f;
    float g_pv[3];
    g_pv[0] = g_rx / geo.tz;
    g_pv[1] = g_ry / geo.tz;
    g_tz -= (g_rx * geo.rx + g_ry * geo.ry) / geo.tz;
    // tz = pv z in front of the near plane (else 1), and the depth
    g_pv[2] = (geo.in_front ? g_tz : 0.0f) + read_or_zero(d_depth, g);

    // xy = ((ph / (ph3 + 1e-7) + 1) size - 1) / 2
    const float g_pp0 = read_or_zero(d_xy, 2 * g) * 0.5f * cam.w;
    const float g_pp1 = read_or_zero(d_xy, 2 * g + 1) * 0.5f * cam.h;
    const float g_ph0 = g_pp0 * geo.pw;
    const float g_ph1 = g_pp1 * geo.pw;
    const float g_pw = g_pp0 * geo.ph[0] + g_pp1 * geo.ph[1];
    const float g_ph3 = -g_pw * geo.pw * geo.pw;

    const float* P = cam.fp;
    for (int k = 0; k < 3; ++k)
      g_xyz[3 * g + k] = g_pv[0] * W[k] + g_pv[1] * W[4 + k] +
                         g_pv[2] * W[8 + k] + g_ph0 * P[k] + g_ph1 * P[4 + k] +
                         g_ph3 * P[12 + k] + gx[k];

    // C = R diag(sm^2) R^T
    const float* R = geo.R;
    float gR[9];
    for (int l = 0; l < 3; ++l) {
      const float ss = geo.sm[l] * geo.sm[l];
      const float r0 = R[l], r1 = R[3 + l], r2 = R[6 + l];
      const float g_ss = gC[0] * r0 * r0 + gC[1] * r0 * r1 +
                         gC[2] * r0 * r2 + gC[3] * r1 * r1 +
                         gC[4] * r1 * r2 + gC[5] * r2 * r2;
      gR[l] = ss * (2.0f * gC[0] * r0 + gC[1] * r1 + gC[2] * r2);
      gR[3 + l] = ss * (gC[1] * r0 + 2.0f * gC[3] * r1 + gC[4] * r2);
      gR[6 + l] = ss * (gC[2] * r0 + gC[4] * r1 + 2.0f * gC[5] * r2);
      // ss = (mod s)^2, s = exp(scaling)
      g_scaling[3 * g + l] = g_ss * 2.0f * geo.sm[l] * cam.mod * geo.s[l];
    }
    // R from the unit quaternion (r, x, y, z)
    const float r = geo.q[0], qx = geo.q[1], qy = geo.q[2], qz = geo.q[3];
    float gq[4];
    gq[0] = 2.0f * (-qz * gR[1] + qy * gR[2] + qz * gR[3] - qx * gR[5] -
                    qy * gR[6] + qx * gR[7]);
    gq[1] = 2.0f * (qy * gR[1] + qz * gR[2] + qy * gR[3] -
                    2.0f * qx * gR[4] - r * gR[5] + qz * gR[6] + r * gR[7] -
                    2.0f * qx * gR[8]);
    gq[2] = 2.0f * (-2.0f * qy * gR[0] + qx * gR[1] + r * gR[2] +
                    qx * gR[3] + qz * gR[5] - r * gR[6] + qz * gR[7] -
                    2.0f * qy * gR[8]);
    gq[3] = 2.0f * (-2.0f * qz * gR[0] - r * gR[1] + qx * gR[2] +
                    r * gR[3] - 2.0f * qz * gR[4] + qy * gR[5] +
                    qx * gR[6] + qy * gR[7]);
    // q = rotation / |rotation|
    const float dot = gq[0] * geo.q[0] + gq[1] * geo.q[1] +
                      gq[2] * geo.q[2] + gq[3] * geo.q[3];
    for (int i = 0; i < 4; ++i)
      g_rot[4 * g + i] = (gq[i] - dot * geo.q[i]) / geo.rn;
  }
  __syncthreads();
  if (stride > 0) stage_out(g_frest + (int64_t)g0 * stride, s_rest, span);
}

template <int D>
cudaError_t launch(cudaStream_t stream, int n, const float* xyz,
                   const float* fdc, const float* frest, int rest,
                   const float* scaling, const float* rotation,
                   const float* opacity, const CamPtrs& cp,
                   const float* d_xy, const float* d_depth,
                   const float* d_conic, const float* d_rgb,
                   const float* d_op, float* g_xyz, float* g_fdc,
                   float* g_frest, float* g_scaling, float* g_rot,
                   float* g_op) {
  const size_t smem = sizeof(float) * kBlock * rest * 3;
  const int blocks = (n + kBlock - 1) / kBlock;
  preprocess_bwd_kernel<D><<<blocks, kBlock, smem, stream>>>(
      n, xyz, fdc, frest, rest, scaling, rotation, opacity, cp, d_xy,
      d_depth, d_conic, d_rgb, d_op, g_xyz, g_fdc, g_frest, g_scaling,
      g_rot, g_op);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. degree in 0..4, rest >= (degree +
// 1)^2 - 1; a null cotangent reads as zero.
extern "C" int rain_preprocess_backward(
    int device, void* stream, int n, int degree, const void* xyz,
    const void* fdc, const void* frest, int rest, const void* scaling,
    const void* rotation, const void* opacity, const void* world_view,
    const void* full_proj, const void* center, const void* tanfovx,
    const void* tanfovy, const void* low_pass, const void* scale_modifier,
    const void* width, const void* height, const void* d_xy,
    const void* d_depth, const void* d_conic, const void* d_rgb,
    const void* d_op, void* g_xyz, void* g_fdc, void* g_frest,
    void* g_scaling, void* g_rot, void* g_op) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const CamPtrs cp{(const float*)world_view, (const float*)full_proj,
                   (const float*)center,     (const float*)tanfovx,
                   (const float*)tanfovy,    (const float*)low_pass,
                   (const float*)scale_modifier, (const int32_t*)width,
                   (const int32_t*)height};
  cudaStream_t s = (cudaStream_t)stream;
#define RAIN_PREP_BWD(DEG)                                                  \
  launch<DEG>(s, n, (const float*)xyz, (const float*)fdc,                  \
              (const float*)frest, rest, (const float*)scaling,            \
              (const float*)rotation, (const float*)opacity, cp,           \
              (const float*)d_xy, (const float*)d_depth,                   \
              (const float*)d_conic, (const float*)d_rgb,                  \
              (const float*)d_op, (float*)g_xyz, (float*)g_fdc,            \
              (float*)g_frest, (float*)g_scaling, (float*)g_rot,           \
              (float*)g_op)
  switch (degree) {
    case 0: return (int)RAIN_PREP_BWD(0);
    case 1: return (int)RAIN_PREP_BWD(1);
    case 2: return (int)RAIN_PREP_BWD(2);
    case 3: return (int)RAIN_PREP_BWD(3);
    case 4: return (int)RAIN_PREP_BWD(4);
  }
#undef RAIN_PREP_BWD
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the degree-3 kernel at rest = 15
// (cudaOccupancy...), into *blocks.
extern "C" int rain_preprocess_backward_occupancy(int device, void* stream,
                                                  void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, preprocess_bwd_kernel<3>, kBlock,
      sizeof(float) * kBlock * 15 * 3);
}
