"""The port's Trainer on its own (CPU): the counterparts of
tests/test_training.py, and what the loop adds around the step.

The toy scene follows tests/test_training.py:17-53 (ground-truth Gaussians
rendered from a ring of cameras, a fresh model fitted from noisy init
points), made with the port, so this file needs no JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.train import checkpoint as ckpt
from rain_tpu_torch.train import step as step_mod
from rain_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def make_scene(n_cams=6, n_pts=120, size=48, seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (n_pts, 2)),
                          rng.uniform(3.0, 4.5, (n_pts, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n_pts, 3)).astype(np.float32)
    gt_state = gmod.create_from_pcd(pts, cols, sh_degree=3,
                                    capacity=n_pts, knn_window=16,
                                    device="cpu")
    cams = []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * 0.06
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        w, h = sizes[i] if sizes else (size, size)
        cam = Camera(uid=i, image_name=f"c{i}", R=R, T=np.zeros(3),
                     fovx=0.9, fovy=0.9, image=None, width=w, height=h)
        out = step_mod.eval_render(
            gt_state, cam.render_inputs("cpu"), torch.zeros(3), 0.3,
            width=w, height=h, sh_degree=3, max_instances=4096)
        cam.image = torch.clamp(out.render, 0, 1).numpy()
        cams.append(cam)
    init_pts = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    init_cols = np.clip(cols + rng.normal(0, 0.2, cols.shape),
                        0, 1).astype(np.float32)
    return SceneData(train_cameras=cams[:-1], test_cameras=cams[-1:],
                     points=init_pts, colors=init_cols,
                     nerf_radius=2.0, nerf_translate=np.zeros(3))


@pytest.fixture(scope="module")
def toy_scene():
    return make_scene()


def configs(opt, system, model=None):
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(cfgs["opt"], **opt)
    cfgs["system"] = dataclasses.replace(cfgs["system"], **system)
    cfgs["model"] = dataclasses.replace(cfgs["model"], **(model or {}))
    return cfgs


def trainer(scene, cfgs, path, **kw):
    return Trainer(scene, cfgs, str(path), device="cpu",
                   log_fn=lambda *a: None, **kw)


def state_tensors(tr):
    return (list(tr.state.params) + list(tr.opt_state.mu) +
            list(tr.opt_state.nu) +
            [getattr(tr.state, k) for k in gmod.STAT_FIELDS])


def test_trainer_improves_psnr(toy_scene, tmp_path):
    """tests/test_training.py:61: +2 dB in 60 iterations, with the PLY
    snapshot, the checkpoint and the report's log lines."""
    cfgs = configs(dict(iterations=60, densify_from_iter=10,
                        densification_interval=25, densify_until_iter=50,
                        opacity_reset_interval=10_000),
                   dict(capacity=512, max_instances=8192))
    tr = trainer(toy_scene, cfgs, tmp_path / "out")
    r0 = tr.report(0)
    tr.train(iterations=60, test_iterations=(), save_iterations=(60,),
             checkpoint_iterations=(30,))
    r1 = tr.report(60)
    assert r1["test"]["psnr"] > r0["test"]["psnr"] + 2.0, (r0, r1)
    ply = tmp_path / "out" / "point_cloud" / "iteration_60" / \
        "point_cloud.ply"
    d = ply_io.read_gaussians(ply, max_sh_degree=3)
    assert d["xyz"].shape[0] == tr.state.n_alive
    assert (tmp_path / "out" / "chkpnt30.npz").exists()
    lines = (tmp_path / "out" / "log_file.txt").read_text().splitlines()
    assert [json.loads(x)["iteration"] for x in lines] == [0, 60]
    assert all(torch.isfinite(p).all() for p in tr.state.params)


def test_trainer_resume(toy_scene, tmp_path):
    """tests/test_training.py:90: resume from a checkpoint, which loads
    bit for bit."""
    cfgs = configs(dict(iterations=20, densify_from_iter=1000),
                   dict(capacity=256, max_instances=8192))
    t1 = trainer(toy_scene, cfgs, tmp_path / "o1", tensorboard=False)
    t1.train(iterations=10, test_iterations=(), save_iterations=(),
             checkpoint_iterations=(10,))
    ck = tmp_path / "o1" / "chkpnt10.npz"
    state, opt, it, slr = ckpt.load_checkpoint(ck, capacity=256,
                                               device="cpu")
    assert it == 10 and slr == toy_scene.nerf_radius
    for a, b in zip(list(state.params) + list(opt.mu) + list(opt.nu),
                    state_tensors(t1)):
        assert torch.equal(a, b)
    t2 = trainer(toy_scene, cfgs, tmp_path / "o2", tensorboard=False)
    t2.train(iterations=20, test_iterations=(), save_iterations=(),
             start_checkpoint=str(ck))
    assert t2.iteration == 20
    assert int(t2.opt_state.step) == 20
    assert t2.state.capacity == 4096        # max(256, round_up(4096))


def test_trainer_profile_steps(toy_scene, tmp_path):
    """tests/test_training.py:112: --profile_steps A-B writes a trace."""
    cfgs = configs(dict(iterations=4, densify_from_iter=10_000),
                   dict(capacity=256, max_instances=4096,
                        profile_steps="2-3"))
    tr = trainer(toy_scene, cfgs, tmp_path / "prof", tensorboard=False)
    tr.train(iterations=4, test_iterations=(), save_iterations=())
    traces = list((tmp_path / "prof" / "profile").glob("trace_2-3.json"))
    assert traces and traces[0].stat().st_size > 0
    assert tr.profile is not None and len(tr.profile.key_averages()) > 0


def test_pipelined_verification_matches_sync(toy_scene, tmp_path,
                                             monkeypatch):
    """tests/test_training.py:130: system.pipeline=1 (one-step-late
    verification with rollback and replay) trains bit for bit as
    pipeline=0, across instance-tier overflow retries and densify rounds,
    with random backgrounds drawn from the trainer's generator."""
    calls = []
    step0 = step_mod.train_step

    def counted(*a, **kw):
        out = step0(*a, **kw)
        calls.append((kw["max_instances"], bool(out[2].instance_overflow)))
        return out

    monkeypatch.setattr(step_mod, "train_step", counted)

    def run(pipeline, out):
        cfgs = configs(dict(iterations=12, densify_from_iter=4,
                            densification_interval=6, densify_until_iter=40,
                            opacity_reset_interval=10_000,
                            random_background=True),
                       dict(capacity=512, max_instances=256,
                            pipeline=pipeline, log_every=5))
        tr = trainer(toy_scene, cfgs, tmp_path / out, tensorboard=False)
        tr.train(iterations=12, test_iterations=(), save_iterations=())
        return tr

    t_sync = run(0, "sync")
    sync_calls, calls[:] = list(calls), []
    t_pipe = run(1, "pipe")
    # the too-small tier forced a retry in both
    assert t_sync.max_instances > 256 and any(o for _, o in sync_calls)
    assert any(o for _, o in calls)
    assert t_pipe.max_instances == t_sync.max_instances
    assert t_pipe.state.n_alive == t_sync.state.n_alive
    assert t_pipe.state.capacity == t_sync.state.capacity
    for a, b in zip(state_tensors(t_pipe), state_tensors(t_sync)):
        assert torch.equal(a, b)


def test_non_finite_loss_dumps_the_pre_step_state(toy_scene, tmp_path,
                                                  monkeypatch):
    """A non-finite loss, found one step late, writes the pre-step state
    of that step and raises (reference dgr/__init__.py:73-80)."""
    seen = []
    step0 = step_mod.train_step

    def poisoned(state, opt, *a, **kw):
        seen.append((state, opt))
        s, o, aux = step0(state, opt, *a, **kw)
        if len(seen) == 3:
            aux = aux._replace(loss=torch.tensor(float("nan")))
        return s, o, aux

    monkeypatch.setattr(step_mod, "train_step", poisoned)
    cfgs = configs(dict(iterations=6, densify_from_iter=1000),
                   dict(capacity=256, max_instances=8192))
    tr = trainer(toy_scene, cfgs, tmp_path / "nan", tensorboard=False)
    with pytest.raises(FloatingPointError, match="iteration 3"):
        tr.train(iterations=6, test_iterations=(), save_iterations=())
    state, opt, it, _ = ckpt.load_checkpoint(
        tmp_path / "nan" / "snapshot_iter3.npz", capacity=256, device="cpu")
    pre_state, pre_opt = seen[2]
    assert it == 3 and int(opt.step) == 2 == int(pre_opt.step)
    for a, b in zip(list(state.params) + list(opt.mu),
                    list(pre_state.params) + list(pre_opt.mu)):
        assert torch.equal(a, b)


def test_bucketed_cameras_train_in_tile_buckets(tmp_path, monkeypatch):
    """Mixed camera sizes train in 16-pixel buckets with the true size as
    real_wh (two 0-d int32 tensors, as rain_tpu traces it), and report at
    the exact size."""
    sizes = [(48, 48), (41, 37), (48, 48), (45, 40)]
    scene = make_scene(n_cams=4, n_pts=60, sizes=sizes)
    seen = []
    step0 = step_mod.train_step

    def recorded(*a, **kw):
        assert all(v.dtype == torch.int32 and v.dim() == 0
                   for v in kw["real_wh"])
        seen.append((kw["width"], kw["height"],
                     tuple(int(v) for v in kw["real_wh"])))
        return step0(*a, **kw)

    monkeypatch.setattr(step_mod, "train_step", recorded)
    cfgs = configs(dict(iterations=3, densify_from_iter=1000),
                   dict(capacity=128, max_instances=4096))
    tr = trainer(scene, cfgs, tmp_path / "b", tensorboard=False)
    tr.train(iterations=3, test_iterations=(3,), save_iterations=())
    assert {s[:2] for s in seen} <= {(48, 48)}
    assert {s[2] for s in seen} <= {(48, 48), (41, 37), (45, 40)}
    assert tr.history[-1]["test"]["psnr"] > 0


def test_trainer_device_and_devices(toy_scene, tmp_path):
    """devices=2 needs a torch.distributed group of world size 2 (the
    sharded mode: tests/test_torch_trainer_sharded.py)."""
    cfgs = configs({}, dict(devices=2))
    with pytest.raises(ValueError, match="group of world size 2"):
        trainer(toy_scene, cfgs, tmp_path / "d")
