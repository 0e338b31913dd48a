"""Measure the Morton-window KNN's deviation from the exact result.

Port of tools/knn_deviation.py. ``ops.knn.mean_dist3_auto`` switches from
the exact all-pairs search to the triple-Morton-window upper bound above
2^20 points, as rain_tpu does; the reference (simple_knn.cu:136-210) is
exact at any N. This measures the deviation where the window path
engages, on the tool's cloud (:25-33): half the points around 64 cluster
centres, half uniform in a box, like an SfM init.

Run:  python -m rain_tpu_torch.scripts.knn_deviation [n_points ...]
      [--device cpu]        (default: 1572864 points)

Each size prints the tool's line: both searches' times (host clock up to
a synchronize), the relative error of the mean squared distance (mean,
p99, max) and of the scale it initialises (its square root), and the
share of rows where the window search is exact within 1e-6. It also
counts the rows where the window search falls below the exact result by
more than 1e-6 relative: an upper bound has none. Like the port's other
entry points it runs on the CUDA card and raises without one unless
--device cpu.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.ops import knn

N_POINTS = 1_572_864
BOUND_RTOL = 1e-6


def cloud(n: int, seed: int = 0) -> np.ndarray:
    """The tool's cloud (tools/knn_deviation.py:25-33): n // 2 points
    around 64 centres (sigma 0.2), the rest uniform in [-4, 4]^3."""
    rng = np.random.default_rng(seed)
    n_c = n // 2
    centers = rng.uniform(-3, 3, (64, 3))
    return np.concatenate([
        centers[rng.integers(0, 64, n_c)] + rng.normal(0, 0.2, (n_c, 3)),
        rng.uniform(-4, 4, (n - n_c, 3))]).astype(np.float32)


def deviation(approx: np.ndarray, exact: np.ndarray) -> dict:
    """The tool's statistics of ``approx`` against ``exact`` (f32 arrays
    of the mean squared 3-NN distance), and the rows below the bound."""
    rel = np.abs(approx - exact) / np.maximum(exact, 1e-12)
    # the init takes sqrt(the clamped mean) as its scale
    # (gaussian_model.py:124-127): the error in scale is what matters
    s_rel = np.abs(np.sqrt(approx) - np.sqrt(exact)) / \
        np.maximum(np.sqrt(exact), 1e-12)
    return {"rel_mean": float(rel.mean()),
            "rel_p99": float(np.quantile(rel, 0.99)),
            "rel_max": float(rel.max()),
            "scale_rel_mean": float(s_rel.mean()),
            "scale_rel_max": float(s_rel.max()),
            "exact_rows_pct": float(np.mean(approx <= exact * (1 + 1e-6))
                                    * 100),
            "rows_below_bound": int(np.sum(
                approx < exact * (1 - BOUND_RTOL)))}


def _timed(fn, p):
    if p.is_cuda:
        torch.cuda.synchronize(p.device)
    t = time.perf_counter()
    out = fn(p)
    if p.is_cuda:
        torch.cuda.synchronize(p.device)
    return out.cpu().numpy(), time.perf_counter() - t


def run(n: int, *, device=None, seed: int = 0, log_fn=print) -> dict:
    """Both searches on ``cloud(n, seed)``; returns their times in
    seconds and ``deviation``'s statistics."""
    dev = device_mod.resolve(device)
    p = torch.from_numpy(cloud(n, seed)).to(dev)
    approx, t_approx = _timed(knn.mean_dist3, p)
    exact, t_exact = _timed(knn.mean_dist3_matmul, p)
    rec = {"n": n, "device": str(dev), "morton_s": t_approx,
           "exact_s": t_exact, **deviation(approx, exact)}
    log_fn(f"n={n}: morton {t_approx:.1f}s exact {t_exact:.1f}s | "
           f"mean-dist2 rel err mean {rec['rel_mean']:.2e} p99 "
           f"{rec['rel_p99']:.2e} max {rec['rel_max']:.2e} | "
           f"scale rel err mean {rec['scale_rel_mean']:.2e} max "
           f"{rec['scale_rel_max']:.2e} | exact rows "
           f"{rec['exact_rows_pct']:.2f}% within-bound (morton is an upper "
           f"bound; {rec['rows_below_bound']} rows below it) on {dev}")
    return rec


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_points", nargs="*", type=int, default=[N_POINTS])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> list[dict]:
    args = _parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    return [run(n, device=dev) for n in args.n_points]


if __name__ == "__main__":
    main()
