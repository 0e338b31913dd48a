"""The scene a configuration names, made on the device from the seed.

bench.py's garden proxy (bench.py:58-72, frozen as chip_smoke.py:431-445's
``garden_proxy_state_arrays`` and rain_tpu_torch/scripts/probe_scale.py:
104-128's ``bench_arrays`` and ``build_tier_state``): means uniform in a 6 x 6 x 10 box in front of the
camera, colours uniform in [0, 1] as the SH DC term, higher SH
coefficients normal with a configured sigma, identity rotations, one
opacity logit. The log-scale is a configured number, or ``"knn3"``: the
log of the root of the mean squared distance to the three nearest
neighbours, floored at 1e-7 as 3DGS's ``create_from_pcd`` sets it
(scene/gaussian_model.py:114-137 of the INRIA code), computed here in
plain PyTorch.

Every array comes from one ``torch.Generator`` on the device seeded with
the run's seed, drawn in a fixed order in a few large calls, so a seed
gives the same scene on every run and no array passes through the host.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
KNN_BLOCK = 4096        # query rows per block of the all-pairs search
KNN_CANDIDATES = 8      # candidates per row re-measured by differences


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def mean_sq_dist3(pts: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each point to its three nearest others.
    Candidates come from the all-pairs matmul form in blocks of rows; the
    best KNN_CANDIDATES are measured again as squared differences, whose
    three smallest are averaged."""
    n = pts.shape[0]
    pts = pts - pts.mean(0)
    sq = (pts * pts).sum(1)
    out = torch.empty(n, device=pts.device)
    k = min(KNN_CANDIDATES, n - 1)
    for i in range(0, n, KNN_BLOCK):
        q = pts[i:i + KNN_BLOCK]
        rows = torch.arange(q.shape[0], device=pts.device)
        d2 = sq[i:i + KNN_BLOCK, None] + sq[None, :] - 2.0 * (q @ pts.T)
        d2[rows, rows + i] = float("inf")
        cand = torch.topk(d2, k, dim=1, largest=False).indices
        diff = pts[cand] - q[:, None, :]
        exact = (diff * diff).sum(-1)
        out[i:i + KNN_BLOCK] = torch.topk(exact, 3, dim=1,
                                          largest=False).values.mean(1)
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's Gaussian parameters (float32, on ``device``),
    keyed as the program's GaussianParams fields."""
    n, cap = cfg["n_gaussians"], cfg["capacity"]
    if cap != n:
        raise ValueError("the scenes fill their capacity")
    k_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    gen = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = cfg["box"]["xy"]
    z0, z1 = cfg["box"]["z"]
    xyz = torch.rand((n, 3), generator=gen, **f32)
    xyz[:, :2] = xyz[:, :2] * (hi - lo) + lo
    xyz[:, 2] = xyz[:, 2] * (z1 - z0) + z0
    rgb = torch.rand((n, 3), generator=gen, **f32)
    f_rest = torch.randn((n, k_rest, 3), generator=gen, **f32)
    f_rest *= cfg["f_rest_sigma"]
    if cfg["log_scale"] == "knn3":
        d2 = torch.clamp(mean_sq_dist3(xyz), min=1e-7)
        scaling = torch.log(torch.sqrt(d2))[:, None].expand(n, 3).clone()
    else:
        scaling = torch.full((n, 3), float(cfg["log_scale"]), **f32)
    rotation = torch.zeros((n, 4), **f32)
    rotation[:, 0] = 1.0
    return {"xyz": xyz,
            "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
            "features_rest": f_rest,
            "scaling": scaling,
            "rotation": rotation,
            "opacity": torch.full((n, 1), float(cfg["opacity_logit"]),
                                  **f32)}


def make_targets(n_views: int, height: int, width: int, seed: int,
                 device) -> torch.Tensor:
    """Uniform-noise target images [n_views, 3, H, W] (bench.py:68's
    target, one per pose), from a generator of their own."""
    gen = generator(seed + 1, device)
    return torch.rand((n_views, 3, height, width), generator=gen,
                      dtype=torch.float32, device=device)
