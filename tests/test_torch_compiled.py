"""The compiled step (rain_tpu_torch.train.compiled) on the CPU, where it
runs the eager step: every per-call value as a 0-d tensor, as rain_tpu
traces it, and the keys it compiles by.

- ``train_step`` with low_pass, xyz_lr, the four lrs, real_wh and n_alive
  as 0-d tensors, through ``CompiledStep.train_step``, against
  rain_tpu's jitted step at the exact size and in a tile bucket, at
  tests/test_torch_train_step.py's tolerances (loss and l1 to rtol 1e-5;
  counts, denom and max_radii2d exact; Adam's moments and
  xyz_gradient_accum at the gradient bar 1e-4; the params to rtol 1e-5 /
  atol 1e-7 where the gradient is above 1e-3 of its leaf's largest, and
  within 2·lr elsewhere), and against the same step fed Python numbers,
  bit for bit: a 0-d tensor must not change a rounding (a divisor moved
  from a number to a tensor would, on the card).
- ``eval_render`` with a tensor scale_modifier (and low_pass and
  n_alive) against the eager render fed numbers, bit for bit; the same
  call against rain_tpu's at the oracle tolerances is in
  tests/test_torch_render.py, whose JAX compilation it shares.
- The Trainer's ``_step_keys`` on tests/test_bucketing.py's mixed-size
  scene: one key per bucket, {(64, 48), (128, 96)}, rain_tpu's
  ``_bucket_keys``, made by ``compiled.train_key`` as on the card.
- The inputs the Trainer hands the compiled step hold no Python number
  that changes between iterations: what changes is a device tensor.
- ``densify_and_prune`` and ``reset_opacity`` through CompiledStep on a
  CPU state (seeded by tests/torch_round_cases.py) equal model.densify's
  bit for bit, with the scalars as 0-d tensors and as numbers; their
  keys; ``retire`` drops their keys by capacity alone.

Two JAX compilations (rain_tpu's step at the exact size and bucketed).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rain_tpu_torch.data.cameras import Camera as TCamera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step as tstep
from test_torch_render import BG, CAM, H, M, W, _raw_scene
from test_torch_trainer_port import configs, trainer
import test_torch_train_step as base
import torch_round_cases as rounds
from rain_tpu_torch.model import densify as tdens

torch.set_num_threads(1)


def _scalars(bucketed):
    """The per-call values as 0-d CPU tensors and as Python numbers:
    (low_pass, xyz_lr, opt_cfg_leaves, real_wh, n_alive) each."""
    wh = (base.W, base.H) if bucketed else None
    numbers = (0.3, base.XYZ_LR, base.OPT, wh, base.N)
    f32 = dict(dtype=torch.float32)
    tensors = (torch.tensor(0.3, **f32), torch.tensor(base.XYZ_LR, **f32),
               {k: torch.tensor(v, **f32) for k, v in base.OPT.items()},
               None if wh is None else tuple(
                   torch.tensor(v, dtype=torch.int32) for v in wh),
               torch.tensor(base.N, dtype=torch.int32))
    return numbers, tensors


def _port_step(steps, state, opt, gt, bucketed, values):
    low_pass, xyz_lr, leaves, real_wh, n_alive = values
    camera = TCamera(**base._cam(1)).render_inputs(device="cpu")
    kw = dict(width=base.W, height=base.H)
    if bucketed:
        pad = np.zeros((3, base.BH, base.BW), np.float32)
        pad[:, :base.H, :base.W] = gt
        gt, kw = pad, dict(width=base.BW, height=base.BH)
    return steps.train_step(
        state._replace(n_alive=n_alive), opt, camera, torch.from_numpy(gt),
        torch.from_numpy(base.BG), low_pass, xyz_lr, sh_degree=3,
        max_instances=base.M, opt_cfg_leaves=leaves, real_wh=real_wh, **kw)


def _leaves(out):
    state, opt, aux = out
    return (list(state.params) + [getattr(state, k) for k in
                                  tgmod.STAT_FIELDS] +
            list(opt.mu) + list(opt.nu) + [opt.step, aux.loss, aux.l1,
                                           aux.num_instances,
                                           aux.instance_overflow])


@pytest.mark.parametrize("bucketed", [False, True])
def test_step_with_device_scalars_matches_jax(bucketed):
    gt, j1, jo1, want = base.jax_case(bucketed)
    t1, to1 = base._carry(j1, jo1)
    numbers, tensors = _scalars(bucketed)
    steps = compiled.CompiledStep()
    got = _port_step(steps, t1, to1, gt, bucketed, tensors)
    base.assert_step_matches(got, want)
    assert got[2].n_alive is got[0].n_alive      # the caller's, as given
    # the same step fed Python numbers: the same bits
    again = _port_step(steps, t1, to1, gt, bucketed, numbers)
    for x, y in zip(_leaves(got), _leaves(again)):
        assert torch.equal(x, y)
    key, = steps.train_keys
    assert key == compiled.TrainKey(
        base.BW if bucketed else base.W, base.BH if bucketed else base.H,
        3, base.M, 0.2, True, base.CAPACITY, bucketed)
    assert steps.graphs == {} and steps.captures == []   # none on the CPU


def test_eval_render_with_a_tensor_scale_modifier():
    """The port's eval_render with scale_modifier, low_pass and n_alive as
    0-d tensors (through CompiledStep) equals its render fed numbers bit
    for bit; tests/test_torch_render.py::
    test_eval_render_with_device_scalars_matches_jax holds the same call
    to rain_tpu's at the oracle tolerances (in that file's JAX
    compilation)."""
    state = tgmod.from_arrays(**_raw_scene(3), capacity=320, device="cpu")
    cam = TCamera(**CAM).render_inputs(device="cpu")
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    steps = compiled.CompiledStep()
    got = steps.eval_render(
        state._replace(n_alive=torch.tensor(state.n_alive,
                                            dtype=torch.int32)),
        cam, torch.from_numpy(BG), torch.tensor(0.3), torch.tensor(0.7),
        **kw)
    numbers = tstep.eval_render(state, cam, torch.from_numpy(BG), 0.3, 0.7,
                                **kw)
    for x, y in zip(got, numbers):
        assert torch.equal(x, y)
    assert int(got.num_instances) > 0
    assert steps.eval_keys == {compiled.EvalKey(W, H, 3, M, 320)}


def _bucket_scene():
    """tests/test_bucketing.py:98-117's scene: 3 camera sizes, two in one
    tile bucket, each twice; 100 points."""
    rng = np.random.default_rng(3)
    sizes = [(61, 45), (64, 47), (126, 89)]
    cams = []
    for i, (w, h) in enumerate(sizes * 2):
        img = rng.uniform(0.2, 0.8, (3, h, w)).astype(np.float32)
        ang = 0.05 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(TCamera(uid=i, image_name=f"c{i}", R=R, T=np.zeros(3),
                            fovx=0.9, fovy=0.8, image=img, width=w,
                            height=h))
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (100, 2)),
                          rng.uniform(3.0, 4.0, (100, 1))],
                         axis=1).astype(np.float32)
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=rng.uniform(0, 1, (100, 3)).astype(np.float32),
                     nerf_radius=2.0, nerf_translate=np.zeros(3))


def test_trainer_one_step_key_per_bucket(tmp_path):
    """The port of test_bucketing.py::test_trainer_one_compile_per_bucket:
    8 iterations over 3 camera sizes in 2 buckets give 2 step keys, one
    per bucket: rain_tpu's _bucket_keys {(64, 48), (128, 96)}."""
    cfgs = configs(dict(iterations=8, densify_from_iter=10 ** 9),
                   dict(capacity=128, max_instances=8192, log_every=4))
    tr = trainer(_bucket_scene(), cfgs, tmp_path / "out",
                 tensorboard=False)
    assert tr._bucketed
    tr.train(iterations=8, test_iterations=(), save_iterations=())
    assert {(k.width, k.height) for k in tr._step_keys} == \
        {(64, 48), (128, 96)}
    assert len(tr._step_keys) == 2
    assert all(isinstance(k, compiled.TrainKey) and k.bucketed and
               k.capacity == 128 and k.max_instances == 8192
               for k in tr._step_keys)
    v = tr.flush_pending()
    assert np.isfinite(v.loss)


def _numbers(x, path=""):
    """{path: value} of the Python numbers in x (tuples, NamedTuples,
    lists and dicts walked), and {path: tensor} of its tensors."""
    nums, tens = {}, {}
    if isinstance(x, torch.Tensor):
        tens[path] = x
    elif isinstance(x, (bool, int, float)):
        nums[path] = x
    elif isinstance(x, dict):
        for k, v in x.items():
            n, t = _numbers(v, f"{path}.{k}")
            nums.update(n)
            tens.update(t)
    elif isinstance(x, (tuple, list)):
        names = getattr(x, "_fields", range(len(x)))
        for k, v in zip(names, x):
            n, t = _numbers(v, f"{path}.{k}")
            nums.update(n)
            tens.update(t)
    return nums, tens


def test_trainer_inputs_hold_no_changing_number(tmp_path, monkeypatch):
    """Every input the Trainer gives CompiledStep.train_step, across a
    densify round (n_alive changes) and the c2f low-pass schedule (low_pass
    changes): its Python numbers are the same at every call, and xyz_lr,
    low_pass, the lrs and n_alive are 0-d device tensors."""
    from test_torch_trainer_port import make_scene
    calls = []
    method = compiled.CompiledStep.train_step

    def recorded(self, *a, **kw):
        calls.append(_numbers((a, kw)))
        return method(self, *a, **kw)

    monkeypatch.setattr(compiled.CompiledStep, "train_step", recorded)
    cfgs = configs(dict(iterations=6, densify_from_iter=2,
                        densification_interval=3, densify_until_iter=100,
                        opacity_reset_interval=10 ** 6),
                   dict(capacity=512, max_instances=8192))
    cfgs["rain"] = dataclasses.replace(cfgs["rain"], c2f=True,
                                       c2f_every_step=2)
    tr = trainer(make_scene(n_pts=120), cfgs, tmp_path / "out",
                 tensorboard=False)
    tr.train(iterations=6, test_iterations=(), save_iterations=())
    assert len(calls) == 6
    nums0 = calls[0][0]
    assert all(nums == nums0 for nums, _ in calls)
    assert set(nums0) == {".1.width", ".1.height", ".1.sh_degree",
                          ".1.max_instances", ".1.lambda_dssim",
                          ".1.update_densify_stats"}
    scalars = [".0.0.n_alive", ".0.5", ".0.6"] + [
        f".1.opt_cfg_leaves.{k}" for k in compiled.OPT_LEAVES]
    for _, tens in calls:
        for p in scalars:
            assert tens[p].dim() == 0 and tens[p].device.type == "cpu", p

    def values(p):
        return [float(tens[p]) for _, tens in calls]

    # what changed between iterations, as tensors
    assert len(set(values(".0.0.n_alive"))) > 1
    assert len(set(values(".0.5"))) > 1           # low_pass
    assert len(set(values(".0.6"))) > 1           # xyz_lr


def test_retire_drops_outgrown_keys():
    steps = compiled.CompiledStep()
    keys = [compiled.TrainKey(64, 48, 0, m, 0.2, True, c, False)
            for c, m in ((512, 8192), (1024, 8192), (1024, 12288))] + [
        compiled.EvalKey(64, 48, 3, 8192, 1024),
        compiled.EvalKey(64, 48, 3, 16384, 1024)]
    steps.graphs = {k: SimpleNamespace(kind=k.capacity) for k in keys}
    steps._buffers = {512: [], 1024: []}
    steps.retire(1024, 12288)
    assert set(steps.graphs) == {keys[2], keys[4]}
    assert set(steps._buffers) == {1024}     # those still in use
    steps.retire(2048, 12288)
    assert steps.graphs == {} and steps._buffers == {}


def test_copy_groups_dtypes_and_fills_numbers():
    dst = [torch.empty(3), torch.empty((), dtype=torch.int32),
           torch.empty(2, dtype=torch.int64), torch.empty(()),
           torch.empty((), dtype=torch.int32)]
    src = [torch.arange(3.0), torch.tensor(7, dtype=torch.int64),
           torch.tensor([5, 6]), 0.25, 9]
    compiled._copy(dst, src)
    assert torch.equal(dst[0], torch.arange(3.0))
    assert dst[1].dtype == torch.int32 and int(dst[1]) == 7
    assert dst[2].tolist() == [5, 6]
    assert float(dst[3]) == 0.25 and int(dst[4]) == 9


@pytest.mark.parametrize("abe_split,use_size_threshold",
                         [(True, False), (False, True)])
def test_densify_and_prune_on_the_cpu_equals_the_eager_round(
        abe_split, use_size_threshold):
    arrays = _raw_scene(3)
    state = tgmod.from_arrays(**arrays, capacity=900, device="cpu")
    steps = compiled.CompiledStep()
    for k, n_alive in enumerate((300, 280)):
        st, opt = rounds.seeded(state, n_alive, seed=k)
        noise = rounds.noise(900, "cpu", seed=10 + k)
        sc = rounds.scalars(k, "cpu", extent=10.0)
        static = dict(abe_split=abe_split,
                      use_size_threshold=use_size_threshold)
        before = rounds.host((st, opt))
        got = steps.densify_and_prune(
            st._replace(n_alive=torch.tensor(n_alive, dtype=torch.int32)),
            opt, noise, **sc, **static)
        want = tdens.densify_and_prune(
            st, opt, noise, **{n: float(v) for n, v in sc.items()},
            **static)
        assert isinstance(got[0].n_alive, int) and got[2] == want[2]
        assert want[2].n_split > 0 and want[2].n_cloned > 0 and \
            want[2].n_pruned > want[2].n_split
        assert rounds.same(got, want)
        assert all(np.array_equal(a, b) for a, b in zip(
            before, rounds.host((st, opt))))     # inputs untouched
    assert steps.densify_keys == {compiled.DensifyKey(
        900, 2, abe_split, use_size_threshold)}
    assert steps.graphs == {} and steps.captures == []


def test_reset_opacity_on_the_cpu_equals_the_eager_reset():
    state = tgmod.from_arrays(**_raw_scene(3), capacity=900, device="cpu")
    st, opt = rounds.seeded(state, 300, seed=4)
    steps = compiled.CompiledStep()
    got = steps.reset_opacity(st, opt, world=2)
    want = tdens.reset_opacity(st, opt)
    assert rounds.same(got, want)
    assert float(torch.sigmoid(got[0].params.opacity).max()) <= 0.0101
    assert steps.reset_keys == {compiled.ResetKey(900, 2)}
    assert steps.graphs == {}


def test_retire_drops_outgrown_round_and_reset_keys():
    """Keys without a tier (the round's, the reset's) are outgrown by their
    whole capacity alone: a reset key of a shard by its capacity times its
    shards."""
    steps = compiled.CompiledStep()
    keys = [compiled.DensifyKey(1024, 2, True, False),
            compiled.DensifyKey(2048, 2, False, True),
            compiled.ResetKey(1024, 1), compiled.ResetKey(512, 2),
            compiled.ResetKey(512, 4),
            compiled.TrainKey(64, 48, 0, 8192, 0.2, True, 2048, False)]
    steps.graphs = {k: SimpleNamespace(kind=(type(k), k.capacity))
                    for k in keys}
    steps._buffers = {(type(k), k.capacity): [] for k in keys}
    steps.retire(2048, 8192)
    assert set(steps.graphs) == {keys[1], keys[4], keys[5]}
    steps.retire(2048, 12288)             # the tier: the step's key only
    assert set(steps.graphs) == {keys[1], keys[4]}
    steps.retire(4096, 12288)
    assert steps.graphs == {} and steps._buffers == {}
