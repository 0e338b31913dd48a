// Per-Gaussian preprocess math shared by the forward kernel
// (preprocess_fwd.cu) and the backward kernel (preprocess_bwd.cu).
//
// The forward is written in the operation order of its plain version,
// model/gaussians.py:activate followed by ops/projection.py:preprocess and
// ops/sh.py:sh_to_rgb as PyTorch runs them on the card: one rounding per
// element-wise operation (the library is built with -fmad=false), the
// matrix-vector products of the projection as cuBLAS takes them (a fused
// multiply-add per term, in term order), and the two small sums as
// PyTorch's reduction kernel takes them (sum4, sum3). So the integer
// outputs (radii, rects, tiles touched), which every later stage reads, are
// those of the plain version bit for bit.
//
// The backward recomputes these intermediates from the raw parameters and
// applies the chain rule of the plain version's autograd graph by hand
// (the reference's backward.cu:133-386 in the port's parameterisation):
// the where-guards pass no gradient through a guarded branch, the clamps
// pass it where their input lies inside the bounds (both ends included),
// and the integer outputs take none. Its sums are in an order of its own,
// so its gradients agree with autograd's to rounding.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rain_prep {

constexpr int kBlock = 128;  // Gaussians (threads) per block
constexpr float kTile = 16.0f;
constexpr float kInvTile = 0.0625f;  // x / 16 == x * (1/16) exactly
constexpr float kNearZ = 0.2f;

// ops/sh.py's constants, rounded to f32 as PyTorch rounds a Python float
// that multiplies an f32 tensor
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f;
constexpr float kC2_1 = -1.0925484305920792f;
constexpr float kC2_2 = 0.31539156525252005f;
constexpr float kC2_3 = -1.0925484305920792f;
constexpr float kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f;
constexpr float kC3_1 = 2.890611442640554f;
constexpr float kC3_2 = -0.4570457994644658f;
constexpr float kC3_3 = 0.3731763325901154f;
constexpr float kC3_4 = -0.4570457994644658f;
constexpr float kC3_5 = 1.445305721320277f;
constexpr float kC3_6 = -0.5900435899266435f;
constexpr float kC4_0 = 2.5033429417967046f;
constexpr float kC4_1 = -1.7701307697799304f;
constexpr float kC4_2 = 0.9461746957575601f;
constexpr float kC4_3 = -0.6690465435572892f;
constexpr float kC4_4 = 0.10578554691520431f;
constexpr float kC4_5 = -0.6690465435572892f;
constexpr float kC4_6 = 0.47308734787878004f;
constexpr float kC4_7 = -1.7701307697799304f;
constexpr float kC4_8 = 0.6258357354491761f;

// The per-call values, as device pointers: a captured graph reads them
// where the compiled step copies each call's values.
struct CamPtrs {
  const float* world_view;  // [4, 4] world -> view
  const float* full_proj;   // [4, 4] world -> clip
  const float* center;      // [3] camera centre
  const float* tanfovx;
  const float* tanfovy;
  const float* low_pass;
  const float* scale_modifier;
  const int32_t* width;     // the true image size (focal, NDC -> pixels)
  const int32_t* height;
};

// The per-call values of one launch, loaded by each block into shared
// memory (load_cam).
struct Cam {
  float wv[12];  // world_view rows 0..2
  float fp[16];
  float cc[3];
  float lp, mod, w, h, fx, fy, limx, limy;
};

__device__ __forceinline__ void load_cam(const CamPtrs& p, Cam& c) {
  for (int i = 0; i < 12; ++i) c.wv[i] = p.world_view[i];
  for (int i = 0; i < 16; ++i) c.fp[i] = p.full_proj[i];
  for (int i = 0; i < 3; ++i) c.cc[i] = p.center[i];
  const float tx = *p.tanfovx, ty = *p.tanfovy;
  c.lp = *p.low_pass;
  c.mod = *p.scale_modifier;
  c.w = (float)*p.width;
  c.h = (float)*p.height;
  // projection.focal_lengths: the size over 2 tan, one division
  c.fx = c.w / (2.0f * tx);
  c.fy = c.h / (2.0f * ty);
  // project_cov2d's 1.3 tan(fov/2)
  c.limx = 1.3f * tx;
  c.limy = 1.3f * ty;
}

// Row i of M @ (x, y, z, 1) for a row-major M with 4 columns, as cuBLAS
// takes an f32 product of depth 4: a fused multiply-add per term in term
// order (the first a plain product).
__device__ __forceinline__ float row4(const float* m, float x, float y,
                                      float z) {
  return __fmaf_rn(1.0f, m[3],
                   __fmaf_rn(z, m[2], __fmaf_rn(y, m[1], x * m[0])));
}

// torch.sum over a contiguous last dimension of 4 and of 3, in the order
// of PyTorch's CUDA reduction: one value per lane, lanes combined by
// shuffles of decreasing offset (4: offsets 2 then 1; 3: two lanes, lane 0
// holding values 0 and 2).
__device__ __forceinline__ float sum4(float a0, float a1, float a2,
                                      float a3) {
  return (a0 + a2) + (a1 + a3);
}
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return (a0 + a2) + a1;
}

// torch.clamp and torch.minimum propagate a NaN (v != v)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// One Gaussian's geometry from its raw parameters, up to the 2D
// covariance (gaussians.activate, projection.preprocess up to the conic).
struct Geo {
  float s[3];    // exp(scaling)
  float sm[3];   // scale_modifier * s
  float rn;      // |rotation|
  float q[4];    // rotation / rn
  float R[9];    // rotation matrix, row-major
  float C[6];    // 3D covariance (00, 01, 02, 11, 12, 22)
  float pv[3];   // view-space mean
  float ph[4];   // clip-space mean
  float pw;      // 1 / (ph[3] + 1e-7)
  bool in_front;
  float tz, rx, ry, tx, ty, inv_tz, inv_tz2;
  float j00, j02, j11, j12;
  float m[6];    // J W rows: m0k = m[k], m1k = m[3 + k]
  float v[6];    // C m rows: v0i = v[i], v1i = v[3 + i]
  float a, b, c; // 2D covariance with low_pass on the diagonal
  float det, det_inv;
  bool det_ok;
};

__device__ __forceinline__ void geometry(const Cam& cam, const float* x,
                                         const float* scaling,
                                         const float* rot, Geo& g) {
  for (int i = 0; i < 3; ++i) g.s[i] = expf(scaling[i]);
  g.rn = sqrtf(sum4(rot[0] * rot[0], rot[1] * rot[1], rot[2] * rot[2],
                    rot[3] * rot[3]));
  for (int i = 0; i < 4; ++i) g.q[i] = rot[i] / g.rn;

  // quat_scale_to_cov3d
  const float r = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
  g.R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.R[1] = 2.0f * (qx * qy - r * qz);
  g.R[2] = 2.0f * (qx * qz + r * qy);
  g.R[3] = 2.0f * (qx * qy + r * qz);
  g.R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.R[5] = 2.0f * (qy * qz - r * qx);
  g.R[6] = 2.0f * (qx * qz - r * qy);
  g.R[7] = 2.0f * (qy * qz + r * qx);
  g.R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  float ss[3];
  for (int i = 0; i < 3; ++i) {
    g.sm[i] = cam.mod * g.s[i];
    ss[i] = g.sm[i] * g.sm[i];
  }
  const float* R = g.R;
  // (i, j) of each packed entry
  const int pi[6] = {0, 0, 0, 1, 1, 2};
  const int pj[6] = {0, 1, 2, 1, 2, 2};
  for (int k = 0; k < 6; ++k) {
    const float* ri = R + 3 * pi[k];
    const float* rj = R + 3 * pj[k];
    g.C[k] = ss[0] * ri[0] * rj[0] + ss[1] * ri[1] * rj[1] +
             ss[2] * ri[2] * rj[2];
  }

  for (int i = 0; i < 3; ++i) g.pv[i] = row4(cam.wv + 4 * i, x[0], x[1], x[2]);
  for (int i = 0; i < 4; ++i) g.ph[i] = row4(cam.fp + 4 * i, x[0], x[1], x[2]);
  g.pw = 1.0f / (g.ph[3] + 1e-7f);
  g.in_front = g.pv[2] > kNearZ;

  // project_cov2d
  g.tz = g.in_front ? g.pv[2] : 1.0f;
  g.rx = g.pv[0] / g.tz;
  g.ry = g.pv[1] / g.tz;
  g.tx = clampf(g.rx, -cam.limx, cam.limx) * g.tz;
  g.ty = clampf(g.ry, -cam.limy, cam.limy) * g.tz;
  g.inv_tz = 1.0f / g.tz;
  g.inv_tz2 = g.inv_tz * g.inv_tz;
  g.j00 = cam.fx * g.inv_tz;
  g.j02 = -(cam.fx * g.tx) * g.inv_tz2;
  g.j11 = cam.fy * g.inv_tz;
  g.j12 = -(cam.fy * g.ty) * g.inv_tz2;
  const float* W = cam.wv;
  for (int k = 0; k < 3; ++k) {
    g.m[k] = g.j00 * W[k] + g.j02 * W[8 + k];
    g.m[3 + k] = g.j11 * W[4 + k] + g.j12 * W[8 + k];
  }
  const float* C = g.C;
  const float* m0 = g.m;
  const float* m1 = g.m + 3;
  g.v[0] = C[0] * m0[0] + C[1] * m0[1] + C[2] * m0[2];
  g.v[1] = C[1] * m0[0] + C[3] * m0[1] + C[4] * m0[2];
  g.v[2] = C[2] * m0[0] + C[4] * m0[1] + C[5] * m0[2];
  g.v[3] = C[0] * m1[0] + C[1] * m1[1] + C[2] * m1[2];
  g.v[4] = C[1] * m1[0] + C[3] * m1[1] + C[4] * m1[2];
  g.v[5] = C[2] * m1[0] + C[4] * m1[1] + C[5] * m1[2];
  const float cov00 = m0[0] * g.v[0] + m0[1] * g.v[1] + m0[2] * g.v[2];
  const float cov01 = m1[0] * g.v[0] + m1[1] * g.v[1] + m1[2] * g.v[2];
  const float cov11 = m1[0] * g.v[3] + m1[1] * g.v[4] + m1[2] * g.v[5];
  g.a = cov00 + cam.lp;
  g.b = cov01;
  g.c = cov11 + cam.lp;

  // preprocess: the conic's determinant
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det != 0.0f;
  g.det_inv = g.det_ok ? 1.0f / g.det : 0.0f;
}

__device__ __forceinline__ float sigmoid(float logit) {
  return 1.0f / (1.0f + expf(-logit));
}

// The SH basis of degree D at a unit direction: term k of the colour is
// b[k] * sh[k], summed in k order from b[0] sh[0] (sh.eval_sh; a term that
// eval_sh subtracts has its sign in b[k]).
template <int D>
__device__ __forceinline__ void sh_basis(const float* dir, float* b) {
  b[0] = kC0;
  if (D > 0) {
    const float x = dir[0], y = dir[1], z = dir[2];
    b[1] = -(kC1 * y);
    b[2] = kC1 * z;
    b[3] = -(kC1 * x);
    if (D > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      b[4] = kC2_0 * xy;
      b[5] = kC2_1 * yz;
      b[6] = kC2_2 * (2.0f * zz - xx - yy);
      b[7] = kC2_3 * xz;
      b[8] = kC2_4 * (xx - yy);
      if (D > 2) {
        b[9] = kC3_0 * y * (3.0f * xx - yy);
        b[10] = kC3_1 * xy * z;
        b[11] = kC3_2 * y * (4.0f * zz - xx - yy);
        b[12] = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        b[13] = kC3_4 * x * (4.0f * zz - xx - yy);
        b[14] = kC3_5 * z * (xx - yy);
        b[15] = kC3_6 * x * (xx - 3.0f * yy);
        if (D > 3) {
          b[16] = kC4_0 * xy * (xx - yy);
          b[17] = kC4_1 * yz * (3.0f * xx - yy);
          b[18] = kC4_2 * xy * (7.0f * zz - 1.0f);
          b[19] = kC4_3 * yz * (7.0f * zz - 3.0f);
          b[20] = kC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
          b[21] = kC4_5 * xz * (7.0f * zz - 3.0f);
          b[22] = kC4_6 * (xx - yy) * (7.0f * zz - 1.0f);
          b[23] = kC4_7 * xz * (xx - 3.0f * yy);
          b[24] = kC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
        }
      }
    }
  }
}

// The columns of d b[k] / d dir (k = 1 .. (D+1)^2 - 1) dotted with e[k],
// added into gd (the reference's backward.cu:9-128 in eval_sh's basis).
template <int D>
__device__ __forceinline__ void sh_basis_vjp(const float* dir, const float* e,
                                             float* gd) {
  if (D == 0) return;
  const float x = dir[0], y = dir[1], z = dir[2];
  float gx = -kC1 * e[3], gy = -kC1 * e[1], gz = kC1 * e[2];
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += kC2_0 * y * e[4] + kC2_2 * (-2.0f * x) * e[6] +
          kC2_3 * z * e[7] + kC2_4 * (2.0f * x) * e[8];
    gy += kC2_0 * x * e[4] + kC2_1 * z * e[5] +
          kC2_2 * (-2.0f * y) * e[6] + kC2_4 * (-2.0f * y) * e[8];
    gz += kC2_1 * y * e[5] + kC2_2 * (4.0f * z) * e[6] +
          kC2_3 * x * e[7];
    if (D > 2) {
      gx += kC3_0 * (6.0f * xy) * e[9] + kC3_1 * yz * e[10] +
            kC3_2 * (-2.0f * xy) * e[11] + kC3_3 * (-6.0f * xz) * e[12] +
            kC3_4 * (4.0f * zz - 3.0f * xx - yy) * e[13] +
            kC3_5 * (2.0f * xz) * e[14] +
            kC3_6 * (3.0f * xx - 3.0f * yy) * e[15];
      gy += kC3_0 * (3.0f * xx - 3.0f * yy) * e[9] + kC3_1 * xz * e[10] +
            kC3_2 * (4.0f * zz - xx - 3.0f * yy) * e[11] +
            kC3_3 * (-6.0f * yz) * e[12] + kC3_4 * (-2.0f * xy) * e[13] +
            kC3_5 * (-2.0f * yz) * e[14] + kC3_6 * (-6.0f * xy) * e[15];
      gz += kC3_1 * xy * e[10] + kC3_2 * (8.0f * yz) * e[11] +
            kC3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * e[12] +
            kC3_4 * (8.0f * xz) * e[13] + kC3_5 * (xx - yy) * e[14];
      if (D > 3) {
        const float z7m1 = 7.0f * zz - 1.0f, z7m3 = 7.0f * zz - 3.0f;
        gx += kC4_0 * y * (3.0f * xx - yy) * e[16] +
              kC4_1 * (6.0f * xy * z) * e[17] + kC4_2 * y * z7m1 * e[18] +
              kC4_5 * z * z7m3 * e[21] + kC4_6 * (2.0f * x) * z7m1 * e[22] +
              kC4_7 * z * (3.0f * xx - 3.0f * yy) * e[23] +
              kC4_8 * (4.0f * x * (xx - 3.0f * yy)) * e[24];
        gy += kC4_0 * x * (xx - 3.0f * yy) * e[16] +
              kC4_1 * (3.0f * z * (xx - yy)) * e[17] +
              kC4_2 * x * z7m1 * e[18] + kC4_3 * z * z7m3 * e[19] +
              kC4_6 * (-2.0f * y) * z7m1 * e[22] +
              kC4_7 * (-6.0f * xy * z) * e[23] +
              kC4_8 * (4.0f * y * (yy - 3.0f * xx)) * e[24];
        gz += kC4_1 * y * (3.0f * xx - yy) * e[17] +
              kC4_2 * (14.0f * xy * z) * e[18] +
              kC4_3 * y * (21.0f * zz - 3.0f) * e[19] +
              kC4_4 * z * (140.0f * zz - 60.0f) * e[20] +
              kC4_5 * x * (21.0f * zz - 3.0f) * e[21] +
              kC4_6 * (14.0f * z * (xx - yy)) * e[22] +
              kC4_7 * x * (xx - 3.0f * yy) * e[23];
      }
    }
  }
  gd[0] += gx;
  gd[1] += gy;
  gd[2] += gz;
}

// The direction from the camera centre (sh.sh_to_rgb): d = x - centre,
// its squared length and d / |d| (0 where |d| = 0).
struct Dir {
  float d[3], sq, inv, u[3];
  bool ok;
};

__device__ __forceinline__ void direction(const Cam& cam, const float* x,
                                          Dir& r) {
  for (int i = 0; i < 3; ++i) r.d[i] = x[i] - cam.cc[i];
  r.sq = sum3(r.d[0] * r.d[0], r.d[1] * r.d[1], r.d[2] * r.d[2]);
  r.ok = r.sq > 0.0f;
  r.inv = rsqrtf(r.ok ? r.sq : 1.0f);
  for (int i = 0; i < 3; ++i) r.u[i] = r.ok ? r.d[i] * r.inv : 0.0f;
}

// Copies `count` floats from src to shared dst with the block's threads,
// 16 bytes a thread where src is 16-byte aligned (dst always is).
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kBlock) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kBlock) dst[i] = src[i];
}

// The other way: shared src to device dst.
__device__ __forceinline__ void stage_out(float* dst, const float* src,
                                          int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kBlock) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kBlock) dst[i] = src[i];
}

}  // namespace rain_prep
