"""The harness at tiny sizes on the CPU: a sound run is correct; each
fault the cells can have, planted under the timed path, makes it
incorrect; the control (the reference in bfloat16 in the program's
place) fails the cells' limits; new cells, traffic and metrics are found
from files alone; nothing imports JAX or rain_tpu; without a card the
command fails and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gsbench import calibrate, run
from gsbench.tests.conftest import GSBENCH, tiny_root
from rain_tpu_torch.ops import losses

CPU = torch.device("cpu")
SEED = 2**31 + 11
REPO = GSBENCH.parent


def _run(root, cell, fault=None, trace=False):
    result, lines = run.run_cell(cell, SEED, 0.5, trace, CPU, root=root,
                                 fault=fault)
    return result


@pytest.mark.parametrize("cell", ["init262k.train", "garden4m.render"])
def test_a_sound_run_is_correct(tiny, cell):
    result = _run(tiny, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


def _unchanged(inputs, out):
    st, op = inputs
    return st, op, out[2]


def _stale(frames={}):
    def fault(i, out):
        prev = frames.get("last", out)
        frames["last"] = out
        return prev
    return fault


def _half_black(i, out):
    img = out.render.clone()
    img[:, img.shape[1] // 2:] = 0.0
    return out._replace(render=img)


def _altered(i, out):
    img = out.render.clone()
    img[0, img.shape[1] // 2, img.shape[2] // 2] += calibrate.ALTERED
    return out._replace(render=img)


@pytest.mark.parametrize("cell,fault", [
    ("init262k.train", _unchanged),
    ("garden4m.render", _stale()),
    ("garden4m.render", _half_black),
    ("garden4m.render", _altered)])
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    assert not _run(tiny, cell, fault=fault)["correct"]


def test_half_the_rows_in_the_loss_is_not_correct(tiny, monkeypatch):
    def half(image, gt, lambda_dssim=0.2):
        h = image.shape[-2] // 2
        return losses.training_loss.__wrapped__(image[:, :h], gt[:, :h],
                                                lambda_dssim)
    half.__wrapped__ = losses.training_loss
    monkeypatch.setattr(losses, "training_loss", half)
    result = _run(tiny, "init262k.train")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["init262k.train", "garden4m.render"])
def test_the_control_fails_the_limits(tiny, cell, monkeypatch):
    monkeypatch.setattr(run, "ROOT", tiny)
    rows = calibrate.control_readings(cell, SEED, CPU)
    limits = run.load("workloads", cell, tiny)["limits"]
    control = [r for r in rows if r.get("control") == "bfloat16"]
    assert control
    for r in rows:
        assert any(r[k] > limits[k] for k in limits), r


def test_a_new_cell_and_metric_are_found_from_files(tmp_path):
    copy = tmp_path / "copy"
    shutil.copytree(GSBENCH, copy / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = tiny_root(tmp_path / "data")
    for d in ("configs", "traffic", "workloads"):
        shutil.rmtree(copy / "gsbench" / d)
        shutil.copytree(data / d, copy / "gsbench" / d)
    cell = json.loads((copy / "gsbench/workloads/init262k.train.json")
                      .read_text())
    (copy / "gsbench/workloads/extra.train.json").write_text(json.dumps(
        {**cell, "config": "garden_4m"}))
    (copy / "gsbench/metrics/extra.spans.py").write_text(
        'UNIT = "count"\n\n\ndef read(tr):\n'
        '    return float(sum(tr.spans.values()))\n')
    code = ("import json, torch; from gsbench import run; "
            f"r, _ = run.run_cell('extra.train', {SEED}, 0.5, True, "
            "torch.device('cpu')); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["extra.spans"] == {"value": 5.0,
                                                "unit": "count"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_rain_tpu():
    files = [p for p in GSBENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        found = _imports(path) & {"jax", "jaxlib", "flax", "rain_tpu"}
        assert not found, (path, found)
    for path in (GSBENCH / "reference").rglob("*.py"):
        assert "rain_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax():
    code = ("import sys, gsbench.run, gsbench.program, gsbench.calibrate, "
            "gsbench.loops.train, gsbench.loops.render, gsbench.trace; "
            "print(gsbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "gsbench.run", "--workload", "garden4m.train",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
