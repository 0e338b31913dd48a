"""Tests of the port's benchmark. CPU tests run here at tiny sizes; the
tests marked ``card`` need a CUDA card and skip without one (decided in
the ``card`` fixture, never at import)."""

import json
import math
import shutil
from pathlib import Path

import pytest

GSBENCH = Path(__file__).resolve().parents[1]
TINY = {"width": 48, "height": 32, "n_gaussians": 300, "capacity": 300,
        "max_instances": 8192, "box": {"xy": [-3.0, 3.0], "z": [2.0, 12.0]},
        "sh_degree": 3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_root(tmp: Path) -> Path:
    """A data root with the benchmark's traffic, metrics and cells, its
    configurations cut to TINY sizes (for tests only)."""
    root = tmp / "tiny"
    for d in ("traffic", "metrics", "workloads"):
        shutil.copytree(GSBENCH / d, root / d)
    (root / "configs").mkdir()
    for path in (GSBENCH / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY)
        if cfg["log_scale"] != "knn3":
            cfg["log_scale"] = -2.5
        (root / "configs" / path.name).write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in {"warm_steps": 4, "warm_frames": 2,
                                    "sample_frames": 3,
                                    "path_frames": 16}.items() if k in t})
        path.write_text(json.dumps(t))
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


def opacity_logit(p: float) -> float:
    return math.log(p / (1.0 - p))
