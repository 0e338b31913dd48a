"""Port parity for the slice as a whole: eval_render of a trained state.

A JAX state is built with rain_tpu.model.gaussians.from_arrays from seeded
numpy arrays and carried into the port with from_numpy (or through PLY
files, both ways); rain_tpu.train.step.eval_render and
rain_tpu_torch.train.step.eval_render then render the same view on the
CPU, at rain_tpu's oracle tolerances (tests/test_rasterize.py:44-61).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.data import ply as jply
from rain_tpu.data.cameras import Camera as JCamera
from rain_tpu.model import gaussians as jgmod
from rain_tpu.train import checkpoint as jckpt
from rain_tpu.train import step as jstep
from rain_tpu_torch.data.cameras import Camera as TCamera
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.ops import expand as texp
from rain_tpu_torch.ops import render as trender
from rain_tpu_torch.ops import tile_render as ttr
from rain_tpu_torch.train import checkpoint as tckpt
from rain_tpu_torch.train import step as tstep

torch.set_num_threads(1)

W, H = 48, 64
N, CAPACITY = 300, 320
M = 2048
BG = np.array([0.1, 0.2, 0.3], np.float32)
CAM = dict(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3), fovx=0.8,
           fovy=0.6, image=None, width=W, height=H)


def _raw_scene(seed, opac_bias=0.0):
    """Raw (pre-activation) parameters of tests/conftest.py:make_scene."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          rng.uniform(2.0, 6.0, (N, 1))], 1).astype(np.float32)
    scaling = rng.uniform(-3.5, -2.0, (N, 3)).astype(np.float32)
    rotation = rng.normal(size=(N, 4)).astype(np.float32)
    opacity = rng.normal(opac_bias, 1.0, (N, 1)).astype(np.float32)
    shs = rng.normal(0, 0.3, (N, 16, 3)).astype(np.float32)
    return dict(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                scaling=scaling, rotation=rotation, opacity=opacity)


def _jax_render(state, max_instances=M):
    cam = {k: jnp.asarray(v) for k, v in JCamera(**CAM).render_inputs().items()}
    return jstep.eval_render(state, cam, jnp.asarray(BG), 0.3, width=W,
                             height=H, sh_degree=3,
                             max_instances=max_instances)


def _torch_render(state, max_instances=M):
    cam = TCamera(**CAM).render_inputs(device="cpu")
    return tstep.eval_render(state, cam, torch.from_numpy(BG), 0.3, width=W,
                             height=H, sh_degree=3,
                             max_instances=max_instances)


def _carry(jstate):
    return tgmod.from_numpy(
        {k: np.asarray(v) for k, v in jstate.params._asdict().items()},
        int(jstate.n_alive), device="cpu")


def _assert_renders_match(got, want):
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render),
                               rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.n_contrib.numpy(),
                                  np.asarray(want.n_contrib))
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert int(got.num_instances) == int(want.num_instances)
    assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.parametrize("seed,opac_bias", [(0, 0.0), (7, 3.0)])
def test_eval_render_matches_jax(seed, opac_bias):
    # opac_bias=3 → near-opaque Gaussians → exercises early termination
    raw = _raw_scene(seed, opac_bias)
    jstate = jgmod.from_arrays(**raw, capacity=CAPACITY)
    want = _jax_render(jstate)
    got = _torch_render(_carry(jstate))
    assert got.render.shape == (3, H, W) and got.radii.shape == (CAPACITY,)
    _assert_renders_match(got, want)
    assert int(got.num_instances) > 0 and not bool(got.overflow)


def test_eval_render_with_device_scalars_matches_jax():
    """The compiled step's eval_render (the eager one on the CPU) with
    scale_modifier, low_pass and n_alive as 0-d tensors, as rain_tpu
    traces them, against rain_tpu's at scale_modifier 0.7 (a traced
    argument: this file's compilation)."""
    from rain_tpu_torch.train import compiled
    jstate = jgmod.from_arrays(**_raw_scene(3), capacity=CAPACITY)
    cam = {k: jnp.asarray(v) for k, v in JCamera(**CAM).render_inputs().items()}
    want = jstep.eval_render(jstate, cam, jnp.asarray(BG), 0.3, 0.7, width=W,
                             height=H, sh_degree=3, max_instances=M)
    state = _carry(jstate)
    got = compiled.CompiledStep().eval_render(
        state._replace(n_alive=torch.tensor(state.n_alive,
                                            dtype=torch.int32)),
        TCamera(**CAM).render_inputs(device="cpu"), torch.from_numpy(BG),
        torch.tensor(0.3), torch.tensor(0.7), width=W, height=H,
        sh_degree=3, max_instances=M)
    _assert_renders_match(got, want)
    assert int(got.num_instances) > 0 and not bool(got.overflow)


def test_empty_scene_renders_background():
    raw = {k: v[:0] for k, v in _raw_scene(1).items()}
    state = tgmod.from_arrays(**raw, capacity=16, device="cpu")
    out = _torch_render(state)
    want = np.broadcast_to(BG[:, None, None], (3, H, W))
    np.testing.assert_allclose(out.render.numpy(), want, atol=1e-6)
    assert int(out.num_instances) == 0 and not bool(out.overflow)


def test_instance_overflow_flag():
    state = tgmod.from_arrays(**_raw_scene(0), device="cpu")
    full = _torch_render(state)
    out = _torch_render(state, max_instances=256)
    assert bool(out.overflow)
    assert int(out.num_instances) == int(full.num_instances) > 256
    # image still finite (nearest instances kept)
    assert np.isfinite(out.render.numpy()).all()


def test_ply_from_jax_loads_and_renders_in_port(tmp_path):
    raw = _raw_scene(0)
    path = tmp_path / "point_cloud.ply"
    jply.write_gaussians(path, raw["xyz"], raw["f_dc"], raw["f_rest"],
                         raw["opacity"], raw["scaling"], raw["rotation"])
    want = _jax_render(jckpt.load_ply_snapshot(path, capacity=CAPACITY))
    state = tckpt.load_ply_snapshot(path, capacity=CAPACITY, device="cpu")
    assert state.n_alive == N and state.capacity == CAPACITY
    _assert_renders_match(_torch_render(state), want)


def test_ply_from_port_loads_in_jax(tmp_path):
    raw = _raw_scene(0)
    state = tgmod.from_arrays(**raw, capacity=CAPACITY, device="cpu")
    path = tmp_path / "point_cloud.ply"
    tckpt.save_ply_snapshot(path, state)
    d = jply.read_gaussians(path)
    for key in raw:
        np.testing.assert_array_equal(d[key], raw[key], err_msg=key)
    jstate = jckpt.load_ply_snapshot(path, capacity=CAPACITY)
    _assert_renders_match(_torch_render(state), _jax_render(jstate))


def test_on_stage_reports_each_stage_with_its_result():
    state = tgmod.from_arrays(**_raw_scene(0), device="cpu")
    seen = []
    cam = TCamera(**CAM).render_inputs(device="cpu")
    out = tstep.eval_render(state, cam, torch.from_numpy(BG), 0.3, width=W,
                            height=H, sh_degree=3, max_instances=M,
                            on_stage=lambda *kv: seen.append(kv))
    stages = dict(seen)
    assert tuple(name for name, _ in seen) == trender.STAGES
    # the hook changes nothing
    plain = _torch_render(state)
    for got, want in zip(out, plain):
        assert torch.equal(got, want)
    assert stages["assemble"] is out
    # each kernel stage's result is its function of the earlier results
    gx = (W + 15) // 16
    d = stages["depth_sort"]
    cols, keys = texp.expand_instances_torch(
        d.table, d.tiles, d.offs, d.rect_w, d.rect_base, grid_x=gx,
        tile_offset=0, n_tiles=gx * ((H + 15) // 16), max_instances=M)
    assert torch.equal(cols, stages["expand_B1"][0])
    assert torch.equal(keys, stages["expand_B1"][1])
    start, end = stages["tile_ranges"]
    assert torch.equal(
        ttr.composite_forward_torch(stages["tile_sort_gather"], start, end,
                                    0, gx), stages["composite_B3"])
    assert int(end[-1]) == int(out.num_instances)
