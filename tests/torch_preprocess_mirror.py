"""A line-by-line copy of preprocess's CUDA kernels in plain torch, vectorised
over the Gaussians (``csrc/preprocess.cuh``, ``preprocess_fwd.cu``,
``preprocess_bwd.cu``).

The kernels run only on a card; this copy lets the CPU tests hold their
hand-written chain rule to autograd through ops.preprocess.preprocess_torch
(in float64, where rounding cannot hide a wrong term) and their forward to
the plain version. Each function names the kernel code it follows;
tests/test_torch_preprocess_kernel.py holds this copy to the kernels on a
card, so that the two cannot part unseen.
"""

from __future__ import annotations

import torch

from rain_tpu_torch.ops import sh as sh_ops

C1 = sh_ops.SH_C1
C2, C3, C4 = sh_ops.SH_C2, sh_ops.SH_C3, sh_ops.SH_C4
PACKED = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _cam(camera, width, height, low_pass, scale_modifier, dtype):
    """preprocess.cuh:load_cam."""
    c = {k: camera[k].to(dtype) for k in ("world_view", "full_proj",
                                          "camera_center")}
    tx = camera["tanfovx"].to(dtype)
    ty = camera["tanfovy"].to(dtype)
    w = torch.tensor(float(width), dtype=dtype)
    h = torch.tensor(float(height), dtype=dtype)
    return dict(wv=c["world_view"][:3], fp=c["full_proj"],
                cc=c["camera_center"], lp=low_pass, mod=scale_modifier,
                w=w, h=h, fx=w / (2.0 * tx), fy=h / (2.0 * ty),
                limx=1.3 * tx, limy=1.3 * ty)


def _row4(m, x):
    """preprocess.cuh:row4 (the product, not its rounding)."""
    return x[:, 0] * m[0] + x[:, 1] * m[1] + x[:, 2] * m[2] + m[3]


def geometry(cam, x, scaling, rot):
    """preprocess.cuh:geometry."""
    g = {}
    g["s"] = torch.exp(scaling)
    r2 = rot * rot
    g["rn"] = torch.sqrt((r2[:, 0] + r2[:, 2]) + (r2[:, 1] + r2[:, 3]))
    q = rot / g["rn"][:, None]
    g["q"] = q
    r, qx, qy, qz = q.unbind(1)
    R = [1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - r * qz),
         2.0 * (qx * qz + r * qy), 2.0 * (qx * qy + r * qz),
         1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - r * qx),
         2.0 * (qx * qz - r * qy), 2.0 * (qy * qz + r * qx),
         1.0 - 2.0 * (qx * qx + qy * qy)]
    g["R"] = R
    g["sm"] = [cam["mod"] * g["s"][:, i] for i in range(3)]
    ss = [v * v for v in g["sm"]]
    g["C"] = [ss[0] * R[3 * i] * R[3 * j] + ss[1] * R[3 * i + 1] *
              R[3 * j + 1] + ss[2] * R[3 * i + 2] * R[3 * j + 2]
              for i, j in PACKED]
    g["pv"] = [_row4(cam["wv"][i], x) for i in range(3)]
    g["ph"] = [_row4(cam["fp"][i], x) for i in range(4)]
    g["pw"] = 1.0 / (g["ph"][3] + 1e-7)
    g["in_front"] = g["pv"][2] > 0.2
    tz = torch.where(g["in_front"], g["pv"][2], torch.ones_like(g["pv"][2]))
    g["tz"] = tz
    g["rx"] = g["pv"][0] / tz
    g["ry"] = g["pv"][1] / tz
    g["tx"] = torch.clamp(g["rx"], -cam["limx"], cam["limx"]) * tz
    g["ty"] = torch.clamp(g["ry"], -cam["limy"], cam["limy"]) * tz
    g["inv_tz"] = 1.0 / tz
    g["inv_tz2"] = g["inv_tz"] * g["inv_tz"]
    j00 = cam["fx"] * g["inv_tz"]
    j02 = -(cam["fx"] * g["tx"]) * g["inv_tz2"]
    j11 = cam["fy"] * g["inv_tz"]
    j12 = -(cam["fy"] * g["ty"]) * g["inv_tz2"]
    W = cam["wv"]
    m0 = [j00 * W[0, k] + j02 * W[2, k] for k in range(3)]
    m1 = [j11 * W[1, k] + j12 * W[2, k] for k in range(3)]
    C = g["C"]
    Cf = [C[0], C[1], C[2], C[1], C[3], C[4], C[2], C[4], C[5]]
    v0 = [Cf[3 * i] * m0[0] + Cf[3 * i + 1] * m0[1] + Cf[3 * i + 2] * m0[2]
          for i in range(3)]
    v1 = [Cf[3 * i] * m1[0] + Cf[3 * i + 1] * m1[1] + Cf[3 * i + 2] * m1[2]
          for i in range(3)]
    g["m0"], g["m1"], g["v0"], g["v1"] = m0, m1, v0, v1
    cov00 = m0[0] * v0[0] + m0[1] * v0[1] + m0[2] * v0[2]
    cov01 = m1[0] * v0[0] + m1[1] * v0[1] + m1[2] * v0[2]
    cov11 = m1[0] * v1[0] + m1[1] * v1[1] + m1[2] * v1[2]
    g["a"] = cov00 + cam["lp"]
    g["b"] = cov01
    g["c"] = cov11 + cam["lp"]
    g["det"] = g["a"] * g["c"] - g["b"] * g["b"]
    g["det_ok"] = g["det"] != 0.0
    g["det_inv"] = torch.where(
        g["det_ok"], 1.0 / torch.where(g["det_ok"], g["det"],
                                       torch.ones_like(g["det"])),
        torch.zeros_like(g["det"]))
    return g


def sh_basis(deg, u):
    """preprocess.cuh:sh_basis: [K] list of [N] basis values."""
    x, y, z = u.unbind(1)
    b = [torch.full_like(x, sh_ops.SH_C0)]
    if deg > 0:
        b += [-(C1 * y), C1 * z, -(C1 * x)]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
              C2[3] * xz, C2[4] * (xx - yy)]
    if deg > 2:
        b += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
              C3[2] * y * (4.0 * zz - xx - yy),
              C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
              C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
              C3[6] * x * (xx - 3.0 * yy)]
    if deg > 3:
        b += [C4[0] * xy * (xx - yy), C4[1] * yz * (3.0 * xx - yy),
              C4[2] * xy * (7.0 * zz - 1.0), C4[3] * yz * (7.0 * zz - 3.0),
              C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
              C4[5] * xz * (7.0 * zz - 3.0),
              C4[6] * (xx - yy) * (7.0 * zz - 1.0),
              C4[7] * xz * (xx - 3.0 * yy),
              C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return b


def sh_basis_vjp(deg, u, e):
    """preprocess.cuh:sh_basis_vjp: (gx, gy, gz) from e [K] list."""
    x, y, z = u.unbind(1)
    zero = torch.zeros_like(x)
    if deg == 0:
        return zero, zero, zero
    gx, gy, gz = -C1 * e[3], -C1 * e[1], C1 * e[2]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        gx = gx + C2[0] * y * e[4] + C2[2] * (-2.0 * x) * e[6] + \
            C2[3] * z * e[7] + C2[4] * (2.0 * x) * e[8]
        gy = gy + C2[0] * x * e[4] + C2[1] * z * e[5] + \
            C2[2] * (-2.0 * y) * e[6] + C2[4] * (-2.0 * y) * e[8]
        gz = gz + C2[1] * y * e[5] + C2[2] * (4.0 * z) * e[6] + \
            C2[3] * x * e[7]
    if deg > 2:
        gx = gx + C3[0] * (6.0 * xy) * e[9] + C3[1] * yz * e[10] + \
            C3[2] * (-2.0 * xy) * e[11] + C3[3] * (-6.0 * xz) * e[12] + \
            C3[4] * (4.0 * zz - 3.0 * xx - yy) * e[13] + \
            C3[5] * (2.0 * xz) * e[14] + C3[6] * (3.0 * xx - 3.0 * yy) * e[15]
        gy = gy + C3[0] * (3.0 * xx - 3.0 * yy) * e[9] + C3[1] * xz * e[10] + \
            C3[2] * (4.0 * zz - xx - 3.0 * yy) * e[11] + \
            C3[3] * (-6.0 * yz) * e[12] + C3[4] * (-2.0 * xy) * e[13] + \
            C3[5] * (-2.0 * yz) * e[14] + C3[6] * (-6.0 * xy) * e[15]
        gz = gz + C3[1] * xy * e[10] + C3[2] * (8.0 * yz) * e[11] + \
            C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * e[12] + \
            C3[4] * (8.0 * xz) * e[13] + C3[5] * (xx - yy) * e[14]
    if deg > 3:
        z7m1, z7m3 = 7.0 * zz - 1.0, 7.0 * zz - 3.0
        gx = gx + C4[0] * y * (3.0 * xx - yy) * e[16] + \
            C4[1] * (6.0 * xy * z) * e[17] + C4[2] * y * z7m1 * e[18] + \
            C4[5] * z * z7m3 * e[21] + C4[6] * (2.0 * x) * z7m1 * e[22] + \
            C4[7] * z * (3.0 * xx - 3.0 * yy) * e[23] + \
            C4[8] * (4.0 * x * (xx - 3.0 * yy)) * e[24]
        gy = gy + C4[0] * x * (xx - 3.0 * yy) * e[16] + \
            C4[1] * (3.0 * z * (xx - yy)) * e[17] + \
            C4[2] * x * z7m1 * e[18] + C4[3] * z * z7m3 * e[19] + \
            C4[6] * (-2.0 * y) * z7m1 * e[22] + \
            C4[7] * (-6.0 * xy * z) * e[23] + \
            C4[8] * (4.0 * y * (yy - 3.0 * xx)) * e[24]
        gz = gz + C4[1] * y * (3.0 * xx - yy) * e[17] + \
            C4[2] * (14.0 * xy * z) * e[18] + \
            C4[3] * y * (21.0 * zz - 3.0) * e[19] + \
            C4[4] * z * (140.0 * zz - 60.0) * e[20] + \
            C4[5] * x * (21.0 * zz - 3.0) * e[21] + \
            C4[6] * (14.0 * z * (xx - yy)) * e[22] + \
            C4[7] * x * (xx - 3.0 * yy) * e[23]
    return gx, gy, gz


def direction(cam, x):
    """preprocess.cuh:direction."""
    d = x - cam["cc"]
    sq = (d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2]) + d[:, 1] * d[:, 1]
    ok = sq > 0
    inv = torch.rsqrt(torch.where(ok, sq, torch.ones_like(sq)))
    u = torch.where(ok[:, None], d * inv[:, None], torch.zeros_like(d))
    return d, sq, ok, inv, u


def colour(deg, params, u):
    """The SH sum of preprocess_fwd.cu / _bwd.cu: (b, sh rows, raw + 0.5)."""
    b = sh_basis(deg, u)
    sh = [params.features_dc[:, 0]] + [params.features_rest[:, k]
                                       for k in range(len(b) - 1)]
    acc = b[0][:, None] * sh[0]
    for k in range(1, len(b)):
        acc = acc + b[k][:, None] * sh[k]
    return b, sh, acc + 0.5


def _rect(x, y, rx, ry, gx, gy):
    """preprocess_fwd.cu:make_rect: (x0, y0, w, h)."""
    x0 = torch.clamp(torch.floor((x - rx) * 0.0625), 0, gx)
    y0 = torch.clamp(torch.floor((y - ry) * 0.0625), 0, gy)
    x1 = torch.clamp(torch.floor((x + rx + 16.0 - 1.0) * 0.0625), 0, gx)
    y1 = torch.clamp(torch.floor((y + ry + 16.0 - 1.0) * 0.0625), 0, gy)
    return x0, y0, (x1 - x0).to(torch.int32), (y1 - y0).to(torch.int32)


def forward(params, alive, camera, width, height, low_pass, scale_modifier,
            deg, grid, tight=True):
    """preprocess_fwd.cu's kernel body: Preprocessed's nine fields, as a
    dict."""
    dt = params.xyz.dtype
    cam = _cam(camera, width, height, low_pass, scale_modifier, dt)
    x = params.xyz
    geo = geometry(cam, x, params.scaling, params.rotation)
    op = torch.sigmoid(params.opacity[:, 0])
    mid = 0.5 * (geo["a"] + geo["c"])
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - geo["det"], min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    px = ((geo["ph"][0] * geo["pw"] + 1.0) * cam["w"] - 1.0) * 0.5
    py = ((geo["ph"][1] * geo["pw"] + 1.0) * cam["h"] - 1.0) * 0.5
    _, _, rw, rh = _rect(px, py, radius, radius, *grid)
    visible = alive & geo["in_front"] & geo["det_ok"] & (rw * rh > 0)
    r_x = r_y = radius
    reachable = torch.ones_like(visible)
    if tight:
        lim = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * op, min=1e-6))
                          + 0.02, min=0.0)
        r_x = torch.minimum(radius, torch.ceil(torch.sqrt(lim * geo["a"]))
                            + 1.0)
        r_y = torch.minimum(radius, torch.ceil(torch.sqrt(lim * geo["c"]))
                            + 1.0)
        reachable = op >= 1.0 / 255.0
    x0, y0, w, h = _rect(px, py, r_x, r_y, *grid)
    *_, u = direction(cam, x)
    _, _, raw = colour(deg, params, u)
    zero = torch.zeros_like(w)
    return dict(
        xy=torch.stack([px, py], 1), depth=geo["pv"][2],
        conic=torch.stack([geo["c"] * geo["det_inv"],
                           -geo["b"] * geo["det_inv"],
                           geo["a"] * geo["det_inv"]], 1),
        rgb=torch.clamp(raw, min=0.0), opacity=op,
        radii=torch.where(visible, radius.to(torch.int32), zero),
        rect_min=torch.stack([x0, y0], 1).to(torch.int32),
        rect_wh=torch.stack([w, h], 1),
        tiles_touched=torch.where(visible & reachable, w * h, zero))


def backward(params, camera, width, height, low_pass, scale_modifier, deg,
             d_xy, d_depth, d_conic, d_rgb, d_op):
    """preprocess_bwd.cu's kernel body: the six leaves' gradients."""
    dt = params.xyz.dtype
    cam = _cam(camera, width, height, low_pass, scale_modifier, dt)
    x = params.xyz
    geo = geometry(cam, x, params.scaling, params.rotation)
    d, sq, ok, inv, u = direction(cam, x)

    op = torch.sigmoid(params.opacity[:, 0])
    g_op = d_op * (1.0 - op) * op

    b, sh, raw = colour(deg, params, u)
    ge = torch.where(raw >= 0.0, d_rgb, torch.zeros_like(d_rgb))
    g_fdc = sh_ops.SH_C0 * ge
    e = [None] + [(sh[k] * ge).sum(1) for k in range(1, len(b))]
    g_rest = torch.zeros_like(params.features_rest)
    for k in range(1, len(b)):
        g_rest[:, k - 1] = b[k][:, None] * ge
    gu = sh_basis_vjp(deg, u, e)
    ginv = gu[0] * d[:, 0] + gu[1] * d[:, 1] + gu[2] * d[:, 2]
    gsq = ginv * -0.5 * inv * inv * inv
    gx = [torch.where(ok, gu[i] * inv + 2.0 * d[:, i] * gsq,
                      torch.zeros_like(inv)) for i in range(3)]

    ga, gb, gc = d_conic.unbind(1)
    g_a = gc * geo["det_inv"]
    g_b = -(gb * geo["det_inv"])
    g_c = ga * geo["det_inv"]
    g_di = ga * geo["c"] - gb * geo["b"] + gc * geo["a"]
    g_det = torch.where(geo["det_ok"],
                        -g_di * geo["det_inv"] * geo["det_inv"],
                        torch.zeros_like(g_di))
    g_a = g_a + g_det * geo["c"]
    g_c = g_c + g_det * geo["a"]
    g_b = g_b + -2.0 * geo["b"] * g_det

    m0, m1, v0, v1 = geo["m0"], geo["m1"], geo["v0"], geo["v1"]
    gv0 = [g_a * m0[j] + g_b * m1[j] for j in range(3)]
    gv1 = [g_c * m1[j] for j in range(3)]
    gm0 = [g_a * v0[j] for j in range(3)]
    gm1 = [g_b * v0[j] + g_c * v1[j] for j in range(3)]
    C = geo["C"]
    Cf = [C[0], C[1], C[2], C[1], C[3], C[4], C[2], C[4], C[5]]
    gm0 = [gm0[j] + gv0[0] * Cf[j] + gv0[1] * Cf[3 + j] + gv0[2] * Cf[6 + j]
           for j in range(3)]
    gm1 = [gm1[j] + gv1[0] * Cf[j] + gv1[1] * Cf[3 + j] + gv1[2] * Cf[6 + j]
           for j in range(3)]
    G = [gv0[i] * m0[j] + gv1[i] * m1[j] for i in range(3) for j in range(3)]
    gC = [G[0], G[1] + G[3], G[2] + G[6], G[4], G[5] + G[7], G[8]]

    W = cam["wv"]
    g_j00 = sum(gm0[k] * W[0, k] for k in range(3))
    g_j02 = sum(gm0[k] * W[2, k] for k in range(3))
    g_j11 = sum(gm1[k] * W[1, k] for k in range(3))
    g_j12 = sum(gm1[k] * W[2, k] for k in range(3))
    fx, fy = cam["fx"], cam["fy"]
    g_tx = -(g_j02 * geo["inv_tz2"]) * fx
    g_ty = -(g_j12 * geo["inv_tz2"]) * fy
    g_inv_tz2 = g_j02 * -(fx * geo["tx"]) + g_j12 * -(fy * geo["ty"])
    g_inv_tz = g_j00 * fx + g_j11 * fy + g_inv_tz2 * 2.0 * geo["inv_tz"]
    g_tz = -g_inv_tz * geo["inv_tz"] * geo["inv_tz"]
    limx, limy = cam["limx"], cam["limy"]
    cx = torch.clamp(geo["rx"], -limx, limx)
    cy = torch.clamp(geo["ry"], -limy, limy)
    g_tz = g_tz + g_tx * cx + g_ty * cy
    inx = (geo["rx"] >= -limx) & (geo["rx"] <= limx)
    iny = (geo["ry"] >= -limy) & (geo["ry"] <= limy)
    g_rx = torch.where(inx, g_tx * geo["tz"], torch.zeros_like(g_tx))
    g_ry = torch.where(iny, g_ty * geo["tz"], torch.zeros_like(g_ty))
    g_pv0 = g_rx / geo["tz"]
    g_pv1 = g_ry / geo["tz"]
    g_tz = g_tz - (g_rx * geo["rx"] + g_ry * geo["ry"]) / geo["tz"]
    g_pv2 = torch.where(geo["in_front"], g_tz, torch.zeros_like(g_tz)) + \
        d_depth

    g_pp0 = d_xy[:, 0] * 0.5 * cam["w"]
    g_pp1 = d_xy[:, 1] * 0.5 * cam["h"]
    pw, ph = geo["pw"], geo["ph"]
    g_ph0 = g_pp0 * pw
    g_ph1 = g_pp1 * pw
    g_pw = g_pp0 * ph[0] + g_pp1 * ph[1]
    g_ph3 = -g_pw * pw * pw
    P = cam["fp"]
    g_xyz = torch.stack([
        g_pv0 * W[0, k] + g_pv1 * W[1, k] + g_pv2 * W[2, k] +
        g_ph0 * P[0, k] + g_ph1 * P[1, k] + g_ph3 * P[3, k] + gx[k]
        for k in range(3)], dim=1)

    R = geo["R"]
    gR = [None] * 9
    g_scaling = []
    for l in range(3):
        ss = geo["sm"][l] * geo["sm"][l]
        r0, r1, r2 = R[l], R[3 + l], R[6 + l]
        g_ss = gC[0] * r0 * r0 + gC[1] * r0 * r1 + gC[2] * r0 * r2 + \
            gC[3] * r1 * r1 + gC[4] * r1 * r2 + gC[5] * r2 * r2
        gR[l] = ss * (2.0 * gC[0] * r0 + gC[1] * r1 + gC[2] * r2)
        gR[3 + l] = ss * (gC[1] * r0 + 2.0 * gC[3] * r1 + gC[4] * r2)
        gR[6 + l] = ss * (gC[2] * r0 + gC[4] * r1 + 2.0 * gC[5] * r2)
        g_scaling.append(g_ss * 2.0 * geo["sm"][l] * cam["mod"] *
                         geo["s"][:, l])
    r, qx, qy, qz = geo["q"].unbind(1)
    gq = [2.0 * (-qz * gR[1] + qy * gR[2] + qz * gR[3] - qx * gR[5] -
                 qy * gR[6] + qx * gR[7]),
          2.0 * (qy * gR[1] + qz * gR[2] + qy * gR[3] - 2.0 * qx * gR[4] -
                 r * gR[5] + qz * gR[6] + r * gR[7] - 2.0 * qx * gR[8]),
          2.0 * (-2.0 * qy * gR[0] + qx * gR[1] + r * gR[2] + qx * gR[3] +
                 qz * gR[5] - r * gR[6] + qz * gR[7] - 2.0 * qy * gR[8]),
          2.0 * (-2.0 * qz * gR[0] - r * gR[1] + qx * gR[2] + r * gR[3] -
                 2.0 * qz * gR[4] + qy * gR[5] + qx * gR[6] + qy * gR[7])]
    q = geo["q"]
    dot = gq[0] * q[:, 0] + gq[1] * q[:, 1] + gq[2] * q[:, 2] + \
        gq[3] * q[:, 3]
    g_rot = torch.stack([(gq[i] - dot * q[:, i]) / geo["rn"]
                         for i in range(4)], dim=1)
    return (g_xyz, g_fdc[:, None], g_rest, torch.stack(g_scaling, dim=1),
            g_rot, g_op[:, None])
