"""Oracle compositor: a sequential, plain-PyTorch replica of the CUDA loop.

Port of rain_tpu/ops/reference_composite.py, for tests only. It replays
the reference's front-to-back per-pixel compositing
(cuda_rasterizer/forward.cu:251-369) one Gaussian at a time over the whole
image, with every skip and termination rule:

- a Gaussian contributes to a pixel only if the pixel's 16x16 tile lies in
  the Gaussian's rect (tile-list membership), not merely if its alpha is
  large;
- power > 0 → skip; alpha = min(0.99, opacity * exp(power));
  alpha < 1/255 → skip;
- test_T = T*(1-alpha) < 1e-4 → terminate the pixel BEFORE compositing;
- output color = C + T_final * bg; depth is the alpha-weighted
  (unnormalized) sum.

Gaussians are visited in stable (depth, index) order, the binning order.
O(N * H * W): use only for tests and small scenes.
"""

from __future__ import annotations

import torch

from rain_tpu_torch.ops.projection import TILE, Preprocessed

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99


def composite_reference(prep: Preprocessed, width: int, height: int,
                        bg: torch.Tensor) -> dict:
    """Composite all Gaussians over the full image, sequentially.

    Returns a dict with render [3,H,W], depth [1,H,W], final_T [H,W] and
    n_contrib [H,W] (int32, 1-based index of the last composited Gaussian
    in the pixel's tile list — the CUDA n_contrib).
    """
    dev = prep.depth.device
    visible = prep.tiles_touched > 0
    depth_key = torch.where(visible, prep.depth,
                            torch.full_like(prep.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    tile_x = (torch.arange(width, device=dev) // TILE)[None, :]
    tile_y = (torch.arange(height, device=dev) // TILE)[:, None]

    T = torch.ones((height, width), device=dev)
    C = torch.zeros((3, height, width), device=dev)
    D = torch.zeros((height, width), device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    cnt = torch.zeros((height, width), dtype=torch.int32, device=dev)
    last = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for g in order.tolist():
        if not bool(visible[g]):
            continue
        x0, y0 = prep.rect_min[g].tolist()
        w, h = prep.rect_wh[g].tolist()
        member = ((tile_x >= x0) & (tile_x < x0 + w) &
                  (tile_y >= y0) & (tile_y < y0 + h))
        cnt = cnt + member.to(torch.int32)
        dx = prep.xy[g, 0] - px
        dy = prep.xy[g, 1] - py
        a, b, c = prep.conic[g, 0], prep.conic[g, 1], prep.conic[g, 2]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(prep.opacity[g] * torch.exp(power),
                            max=ALPHA_CLAMP)
        ok = member & ~done & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = T * (1.0 - alpha)
        live = ok & (test_t >= T_EPS)
        w_px = torch.where(live, alpha * T, torch.zeros_like(T))
        C = C + w_px[None] * prep.rgb[g][:, None, None]
        D = D + w_px * prep.depth[g]
        T = torch.where(live, test_t, T)
        # T keeps its pre-termination value (forward.cu:339-344)
        done = done | (ok & (test_t < T_EPS))
        last = torch.where(live, cnt, last)
    return {
        "render": C + T[None] * bg[:, None, None],
        "depth": D[None],
        "final_T": T,
        "n_contrib": last,
    }
