"""Port parity for the npz checkpoints and the configuration.

- The npz round trip of tests/test_io.py:46-64 in the port, and files
  crossing packages: one written by rain_tpu loads in the port and one
  written by the port loads in rain_tpu, bit for bit, padded to a larger
  capacity (the keys are the same; only the alive prefix is stored).
- A Trainer resumed from a checkpoint sizes its state as rain_tpu's does
  (rain_tpu/train/trainer.py:439-451) and holds the same bits.
- The config (a copy of rain_tpu/config.py): the same groups, fields and
  defaults, and the same values for the same argv, presets included
  (tests/test_io.py:103-124).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu import config as jcfg
from rain_tpu.model import adam as jadam
from rain_tpu.model import gaussians as jgmod
from rain_tpu.data import cameras as jcameras
from rain_tpu.data import dataset as jdataset
from rain_tpu.train import checkpoint as jckpt
from rain_tpu.train import trainer as jtrainer
from rain_tpu_torch import config as tcfg
from rain_tpu_torch.data import cameras as tcameras
from rain_tpu_torch.data import dataset as tdataset
from rain_tpu_torch.model import adam as tadam
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.train import checkpoint as tckpt
from rain_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

FIELDS = tgmod.GaussianParams._fields


def _points(n=20, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _torch_state(seed=2):
    """A port state with seeded moments and statistics on its 20 rows."""
    rng = np.random.default_rng(seed + 10)
    state = tgmod.create_from_pcd(*_points(seed=seed), sh_degree=3,
                                  capacity=32, knn_window=8, device="cpu")
    for k in tgmod.STAT_FIELDS:
        getattr(state, k)[:20] = torch.from_numpy(
            rng.uniform(0, 5, 20).astype(np.float32))
    opt = tadam.init(state.params)
    for leaf in list(opt.mu) + list(opt.nu):
        leaf[:20] = torch.from_numpy(
            rng.normal(size=leaf[:20].shape).astype(np.float32))
    return state, opt._replace(step=torch.tensor(7, dtype=torch.int32))


def test_trainer_resume_sizes_capacity_as_rain_tpu(tmp_path):
    """A resume sizes the state as rain_tpu/train/trainer.py:439-451 does:
    max(the fresh capacity, round_up(max(5/3 · n_alive, 4096), 4096)),
    whatever ``max_capacity`` says. A checkpoint of 12,000 live rows into
    a scene of 50 points (fresh capacity 16,384) with max_capacity 16,384:
    both packages resume at 20,480 with the same bits. ``train`` to the
    checkpoint's own iteration runs no step, so JAX compiles none."""
    rng = np.random.default_rng(5)
    n = 12_000
    state = tgmod.from_arrays(
        xyz=rng.normal(size=(n, 3)), f_dc=rng.normal(size=(n, 1, 3)),
        f_rest=rng.normal(size=(n, 15, 3)),
        scaling=rng.uniform(-5, -2, (n, 3)), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)), device="cpu")
    path = tmp_path / "ck.npz"
    tckpt.save_checkpoint(path, state, tadam.init(state.params), 40, 2.0)
    pts, cols = _points(n=50)
    cam = dict(uid=0, image_name="c0", R=np.eye(3), T=np.zeros(3),
               fovx=0.9, fovy=0.9, image=None, width=32, height=32)
    scene = dict(points=pts, colors=cols, nerf_radius=2.0,
                 nerf_translate=np.zeros(3))
    trainers = []
    for cfg_mod, cam_cls, scene_cls, trainer_cls, kw in (
            (jcfg, jcameras.Camera, jdataset.SceneData, jtrainer.Trainer, {}),
            (tcfg, tcameras.Camera, tdataset.SceneData, ttrainer.Trainer,
             dict(device="cpu"))):
        cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
        cfgs["system"] = dataclasses.replace(cfgs["system"],
                                             max_capacity=16_384)
        tr = trainer_cls(scene_cls(train_cameras=[cam_cls(**cam)],
                                   test_cameras=[], **scene), cfgs,
                         str(tmp_path / cfg_mod.__name__),
                         log_fn=lambda *a: None, tensorboard=False, **kw)
        assert tr.state.capacity == 16_384
        tr.train(iterations=40, test_iterations=(), save_iterations=(),
                 start_checkpoint=str(path))
        trainers.append(tr)
    jt, tt = trainers
    assert tt.state.capacity == jt.state.capacity == 20_480
    assert tt.state.n_alive == int(jt.state.n_alive) == n
    for a, b in zip(list(tt.state.params) + list(tt.opt_state.mu),
                    list(jt.state.params) + list(jt.opt_state.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_roundtrip(tmp_path):
    state, opt = _torch_state()
    path = tmp_path / "ck.npz"
    tckpt.save_checkpoint(path, state, opt, 123, 4.5)
    st2, opt2, it, slr = tckpt.load_checkpoint(path, capacity=64,
                                               device="cpu")
    assert it == 123 and slr == 4.5
    assert st2.capacity == 64 and st2.n_alive == 20
    assert int(opt2.step) == 7
    for a, b in zip(list(st2.params) + list(opt2.mu) + list(opt2.nu),
                    list(state.params) + list(opt.mu) + list(opt.nu)):
        assert torch.equal(a[:20], b[:20])
    for k in tgmod.STAT_FIELDS:
        assert torch.equal(getattr(st2, k)[:20], getattr(state, k)[:20])
        assert not getattr(st2, k)[20:].any()
    # dead rows: the placeholders, zero moments
    dead = tgmod._dead_fill(44, 15, torch.device("cpu"))
    for a, b in zip(st2.params, dead):
        assert torch.equal(a[20:], b)
    assert not any(m[20:].any() for m in list(opt2.mu) + list(opt2.nu))
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, capacity=10, device="cpu")


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    js = jgmod.create_from_pcd(*_points(), sh_degree=3, capacity=32,
                               knn_window=8)
    rng = np.random.default_rng(4)
    js = js._replace(denom=js.denom.at[:20].set(3.0),
                     max_radii2d=js.max_radii2d.at[:20].set(jnp.asarray(
                         rng.uniform(0, 9, 20).astype(np.float32))))
    jo = jadam.init(js.params)
    jo = jadam.AdamState(
        mu=jo.mu._replace(xyz=jo.mu.xyz.at[:20].set(jnp.asarray(
            rng.normal(size=(20, 3)).astype(np.float32)))),
        nu=jo.nu._replace(opacity=jo.nu.opacity.at[:20].set(0.25)),
        step=jnp.asarray(9, jnp.int32))
    path = tmp_path / "jax.npz"
    jckpt.save_checkpoint(path, js, jo, 77, 2.5)
    ts, to, it, slr = tckpt.load_checkpoint(path, capacity=64, device="cpu")
    js2, jo2, jit_, jslr = jckpt.load_checkpoint(path, capacity=64)
    assert (it, slr, ts.n_alive, int(to.step)) == \
        (jit_, jslr, int(js2.n_alive), int(jo2.step)) == (77, 2.5, 20, 9)
    for a, b in zip(list(ts.params) + list(to.mu) + list(to.nu),
                    list(js2.params) + list(jo2.mu) + list(jo2.nu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in tgmod.STAT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js2, k)))


def test_port_checkpoint_loads_in_jax(tmp_path):
    state, opt = _torch_state(seed=3)
    path = tmp_path / "port.npz"
    tckpt.save_checkpoint(path, state, opt, 31, 1.25)
    js, jo, it, slr = jckpt.load_checkpoint(path, capacity=48)
    assert (it, slr, int(js.n_alive), int(jo.step)) == (31, 1.25, 20, 7)
    assert js.capacity == 48
    for name, a, b in zip(FIELDS, js.params, state.params):
        np.testing.assert_array_equal(np.asarray(a)[:20], b[:20].numpy(),
                                      err_msg=name)
    for a, b in zip(list(jo.mu) + list(jo.nu), list(opt.mu) + list(opt.nu)):
        np.testing.assert_array_equal(np.asarray(a)[:20], b[:20].numpy())
        assert not np.asarray(a)[20:].any()
    for k in tgmod.STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, k))[:20],
                                      getattr(state, k)[:20].numpy())
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["iteration", "n_alive", "spatial_lr_scale", "adam_step",
             *tgmod.STAT_FIELDS] +
            [f"{p}.{f}" for p in ("params", "mu", "nu") for f in FIELDS])


def _cfg_dict(cfgs):
    return {k: dataclasses.asdict(v) for k, v in cfgs.items()}


def test_config_groups_and_defaults_equal():
    assert list(tcfg.GROUPS) == list(jcfg.GROUPS)
    for name in jcfg.GROUPS:
        jf = [(f.name, f.type, f.default)
              for f in dataclasses.fields(jcfg.GROUPS[name])]
        tf = [(f.name, f.type, f.default)
              for f in dataclasses.fields(tcfg.GROUPS[name])]
        assert tf == jf, name
        assert set(getattr(tcfg.GROUPS[name], "SHORTHANDS", ())) == \
            set(getattr(jcfg.GROUPS[name], "SHORTHANDS", ()))


@pytest.mark.parametrize("argv", [
    [],
    ["-s", "/data/garden", "--ours_new", "--iterations", "7000"],
    ["-s", "/data/room", "-m", "/out", "-r", "2", "-w", "--ours",
     "--capacity", "393216", "--max_instances", "262144", "--pipeline", "0",
     "--densify_grad_threshold", "0.0003", "--profile_steps", "5-9"],
])
def test_config_parses_like_rain_tpu(argv, tmp_path):
    j = jcfg.extract_all(jcfg.build_parser("t").parse_args(argv))
    t = tcfg.extract_all(tcfg.build_parser("t").parse_args(argv))
    assert _cfg_dict(t) == _cfg_dict(j)
    src = t["model"].source_path
    jp = jcfg.apply_method_presets(j, src)
    tp = tcfg.apply_method_presets(t, src)
    assert _cfg_dict(tp) == _cfg_dict(jp)
    assert tcfg.explicit_flag_names(argv) == jcfg.explicit_flag_names(argv)
    # saved by one package, loaded by the other
    tcfg.save_config(tp, tmp_path / "t.json")
    jcfg.save_config(jp, tmp_path / "j.json")
    assert _cfg_dict(jcfg.load_config(tmp_path / "t.json")) == \
        _cfg_dict(tcfg.load_config(tmp_path / "j.json")) == _cfg_dict(tp)
    merged_t = tcfg.merge_saved(t, tcfg.load_config(tmp_path / "t.json"),
                                tcfg.explicit_flag_names(argv))
    merged_j = jcfg.merge_saved(j, jcfg.load_config(tmp_path / "j.json"),
                                jcfg.explicit_flag_names(argv))
    assert _cfg_dict(merged_t) == _cfg_dict(merged_j)


def test_config_presets():
    """tests/test_io.py:103-114 in the port."""
    args = tcfg.build_parser("t").parse_args(
        ["-s", "/data/garden", "--ours_new", "--iterations", "7000"])
    cfgs = tcfg.apply_method_presets(tcfg.extract_all(args), "/data/garden")
    assert cfgs["model"].source_path == "/data/garden"
    assert cfgs["opt"].iterations == 7000
    assert cfgs["model"].images == "images_4"
    assert cfgs["rain"].c2f is True
    assert cfgs["rain"].num_gaussians == 10
    assert cfgs["rain"].warmup_iter == 10000
