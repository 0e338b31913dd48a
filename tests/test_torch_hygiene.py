"""Port hygiene: rain_tpu_torch stands alone and defaults to the card.

- No module of the port (the data loaders, the native parser's loader,
  LPIPS, the viewer and the CLIs included), not chip_smoke.py and not the
  helpers of tests/ that chip_smoke.py loads imports jax or rain_tpu.
- Importing the port leaves jax and rain_tpu out of sys.modules.
- An entry point called without ``device`` runs on the CUDA card; with no
  card it raises RuntimeError instead of carrying on on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.eval import lpips
from rain_tpu_torch.model import adam
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.train import checkpoint as ckpt
from rain_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "rain_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_ablate.py"]
# numpy and torch only: chip_smoke.py loads them by path
SMOKE_HELPERS = [ROOT / "tests" / "torch_expand_cases.py",
                 ROOT / "tests" / "torch_reduce_cases.py",
                 ROOT / "tests" / "torch_trainer_trace.py",
                 ROOT / "tests" / "torch_colmap_scene.py"]
# modules the walk must find, one of each package
WALKED = ("rain_tpu_torch.train.step", "rain_tpu_torch.data.images",
          "rain_tpu_torch.data.colmap", "rain_tpu_torch.native",
          "rain_tpu_torch.eval.lpips", "rain_tpu_torch.viewer.network_gui",
          "rain_tpu_torch.scripts.train", "rain_tpu_torch.scripts.render",
          "rain_tpu_torch.scripts.metrics")
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT_FILES if p.parent != ROOT)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "rain_tpu")


@pytest.mark.parametrize("path", PORT_FILES + SMOKE_HELPERS,
                         ids=lambda p: p.name)
def test_port_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'rain_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert set(WALKED) <= set(PORT_MODULES)


def _raw(n=4):
    rng = np.random.default_rng(0)
    return dict(xyz=rng.normal(size=(n, 3)), f_dc=np.zeros((n, 1, 3)),
                f_rest=np.zeros((n, 15, 3)), scaling=np.full((n, 3), -3.0),
                rotation=np.tile([1.0, 0, 0, 0], (n, 1)),
                opacity=np.zeros((n, 1)))


def _entry_points(tmp_path):
    """Each entry point called without a device."""
    path = tmp_path / "g.ply"
    cpu_state = gmod.from_arrays(**_raw(), device="cpu")
    ckpt.save_ply_snapshot(path, cpu_state)
    npz = tmp_path / "c.npz"
    ckpt.save_checkpoint(npz, cpu_state, adam.init(cpu_state.params), 1, 1.0)
    cam = Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.6, image=None, width=32, height=32)
    pts = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    scene = SceneData(train_cameras=[cam], test_cameras=[], points=pts,
                      colors=np.full((8, 3), 0.5, np.float32),
                      nerf_radius=1.0, nerf_translate=np.zeros(3))
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    return {
        "from_arrays": lambda: gmod.from_arrays(**_raw()).params.xyz,
        "from_numpy": lambda: gmod.from_numpy(
            {"xyz": _raw()["xyz"], "features_dc": _raw()["f_dc"],
             "features_rest": _raw()["f_rest"],
             "scaling": _raw()["scaling"],
             "rotation": _raw()["rotation"],
             "opacity": _raw()["opacity"]}, 4).params.xyz,
        "load_ply_snapshot": lambda: ckpt.load_ply_snapshot(
            path).params.xyz,
        "render_inputs": lambda: cam.render_inputs()["world_view"],
        "create_from_pcd": lambda: gmod.create_from_pcd(
            pts, pts, sh_degree=3, capacity=16).params.xyz,
        "load_checkpoint": lambda: ckpt.load_checkpoint(npz)[0].params.xyz,
        "Trainer": lambda: Trainer(
            scene, cfgs, str(tmp_path / "t"), log_fn=lambda *a: None,
            tensorboard=False).state.params.xyz,
        "make_lpips": lambda: lpips.make_lpips(
            [(np.zeros((1, 3, 3, 3)), np.zeros(1))] +
            [(np.zeros((1, 1, 3, 3)), np.zeros(1))] * 12, None)(
                torch.zeros(3, 16, 16, device="cuda"),
                torch.zeros(3, 16, 16, device="cuda")),
    }


@pytest.mark.parametrize("name", ["from_arrays", "from_numpy",
                                  "load_ply_snapshot", "render_inputs",
                                  "create_from_pcd", "load_checkpoint",
                                  "Trainer", "make_lpips"])
def test_entry_point_defaults_to_cuda(name, tmp_path):
    call = _entry_points(tmp_path)[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
