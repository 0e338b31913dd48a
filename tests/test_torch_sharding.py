"""The port's sharded train step (rain_tpu_torch.parallel.sharding) on the
CPU, one gloo process per rank (parallel.launch.spawn).

- At D = 2, 4 and 8 ranks one step equals the port's single-device
  train_step at tests/test_sharding.py:60-76's bars: loss, l1, params and
  Adam's moments within 1e-5 absolute, xyz_gradient_accum within 1e-5,
  denom and max_radii2d exactly. D = 8 on the image's 4 tile rows leaves
  bands past the last row, which render empty and add zero.
- At D = 2 it equals rain_tpu's sharded step on the same numpy-seeded
  state at the same bars, with every per-call value a number or a 0-d
  tensor (the same bits), and through CompiledStep.sharded_train_step,
  which on gloo runs the eager step.
- A tier of 256 overflows and says so; a rerun gives the same bits;
  distributed.gather_shards passes torch.autograd.gradcheck in f64.

The state is rain_tpu's create_from_pcd of tests/test_sharding.py's
scene, carried over as numpy, so both packages start from the same bits.
One JAX interpret compilation (rain_tpu's sharded step at D = 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.model import adam as jadam
from rain_tpu.model import gaussians as jgmod
from rain_tpu.parallel import sharding as jsharding
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.parallel import launch
from rain_tpu_torch.train import step as tstep
from tests.conftest import make_camera
import torch_sharding_cases as cases

torch.set_num_threads(1)

TIER = 4096
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def start():
    """tests/test_sharding.py's _mkstate (80 points, capacity 128) as
    numpy: (arrays, n_alive)."""
    rng = np.random.default_rng(0)
    n = 80
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(2.5, 5.0, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = jgmod.create_from_pcd(pts, cols, sh_degree=3, capacity=128,
                               knn_window=16)
    return ({k: np.asarray(v) for k, v in js.params._asdict().items()},
            int(js.n_alive))


@pytest.fixture(scope="module")
def single(start):
    """The port's single-device train_step from the same state, as numpy."""
    state, opt, cam, gt, bg = cases.step_inputs(*start, "cpu")
    s, o, aux = tstep.train_step(
        state, opt, cam, gt, bg, cases.LOW_PASS, torch.tensor(cases.XYZ_LR),
        width=cases.W, height=cases.H, sh_degree=3, max_instances=TIER,
        opt_cfg_leaves=cases.OPT_LEAVES, update_densify_stats=True)
    return cases._numpy(s, o, aux)


@pytest.fixture(scope="module")
def sharded(start):
    """The sharded step's result at D ranks, run once per D."""
    runs = {}

    def run(d):
        if d not in runs:
            runs[d] = launch.spawn(cases.sharded_step, d, device="cpu",
                                   timeout_s=TIMEOUT_S,
                                   args=(*start, TIER))[0]
        return runs[d]
    return run


def _assert_step_matches(got, want, what):
    assert abs(got["loss"] - want["loss"]) < 1e-5, what
    assert abs(got["l1"] - want["l1"]) < 1e-5, what
    assert not got["overflow"], what
    for group in ("params", "mu", "nu"):
        for name, a in got[group].items():
            err = np.abs(a - want[group][name]).max()
            assert err < 1e-5, (what, group, name, err)
    np.testing.assert_allclose(got["stats"]["xyz_gradient_accum"],
                               want["stats"]["xyz_gradient_accum"],
                               atol=1e-5, rtol=0, err_msg=what)
    for name in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(got["stats"][name],
                                      want["stats"][name], err_msg=what)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_step_matches_single_device(n_dev, sharded, single):
    got = sharded(n_dev)
    _assert_step_matches(got, single, f"D={n_dev} vs train_step")
    # the densify statistics moved: the tap gradients crossed the bands
    assert got["stats"]["denom"].sum() > 0
    assert got["stats"]["xyz_gradient_accum"].max() > 0


@pytest.fixture(scope="module")
def rain_tpu_d2(start):
    """rain_tpu's make_sharded_train_step at D = 2 on the same state (8
    virtual CPU devices, tests/conftest.py), as ``cases._numpy`` gives
    the port's: the file's one JAX compilation."""
    arrays, n_alive = start
    js = jgmod.GaussianState(
        params=jgmod.GaussianParams(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()}),
        n_alive=jnp.asarray(n_alive, jnp.int32),
        **{k: jnp.zeros(128, jnp.float32) for k in tgmod.STAT_FIELDS})
    step = jsharding.make_sharded_train_step(
        jsharding.make_mesh(2), width=cases.W, height=cases.H, sh_degree=3,
        max_instances_per_shard=TIER, update_densify_stats=True)
    s, o, aux = step(js, jadam.init(js.params), make_camera(cases.W, cases.H),
                     jnp.asarray(cases.gt_image()),
                     jnp.asarray(cases.BG, jnp.float32),
                     jnp.asarray(cases.LOW_PASS, jnp.float32),
                     jnp.asarray(cases.XYZ_LR, jnp.float32), cases.OPT_LEAVES)
    return {"loss": float(aux.loss), "l1": float(aux.l1), "overflow": False,
            "params": {k: np.asarray(v)
                       for k, v in s.params._asdict().items()},
            "stats": {k: np.asarray(getattr(s, k))
                      for k in tgmod.STAT_FIELDS},
            "mu": {k: np.asarray(v) for k, v in o.mu._asdict().items()},
            "nu": {k: np.asarray(v) for k, v in o.nu._asdict().items()}}


def test_sharded_step_matches_rain_tpu(sharded, rain_tpu_d2):
    """D = 2 against rain_tpu's make_sharded_train_step on the same
    state."""
    _assert_step_matches(sharded(2), rain_tpu_d2,
                         "D=2 vs rain_tpu's sharded step")


def test_sharded_step_takes_device_values(start, sharded, rain_tpu_d2):
    """At D = 2, n_alive (int32), low_pass, xyz_lr and the four lrs (f32)
    as 0-d tensors, as rain_tpu traces them and as the compiled step feeds
    its graphs, give the bits of the same step fed numbers on every rank,
    and so does CompiledStep.sharded_train_step, which runs the eager step
    on gloo and captures nothing; the whole result equals the step of
    ``sharded`` (xyz_lr a tensor, the rest numbers) bit for bit and
    rain_tpu's at its bars."""
    ranks = launch.spawn(cases.sharded_step_values, 2, device="cpu",
                         timeout_s=TIMEOUT_S, args=(*start, TIER))
    for r in ranks:
        d = r["digests"]
        assert d["tensors"] == d["numbers"] == d["compiled"], d
        assert (r["graphs"], r["captures"]) == (0, 0)
        assert len(r["keys"]) == 1
    whole = ranks[0]["whole"]
    assert cases.digest(whole["tensors"]) == cases.digest(
        whole["numbers"]) == cases.digest(sharded(2))
    _assert_step_matches(whole["tensors"], rain_tpu_d2,
                         "D=2, device values, vs rain_tpu's sharded step")


def test_sharded_step_reruns_bitwise(start, sharded):
    """A second run at D = 4, in new processes, gives the same bits."""
    again = launch.spawn(cases.sharded_step, 4, device="cpu",
                         timeout_s=TIMEOUT_S, args=(*start, TIER))[0]
    assert cases.digest(again) == cases.digest(sharded(4))


def test_sharded_step_reports_overflow(start):
    """tests/test_sharding.py:79-95: a tier of 256 overflows a band."""
    got = launch.spawn(cases.sharded_step, 2, device="cpu",
                       timeout_s=TIMEOUT_S, args=(*start, 256))[0]
    assert got["overflow"]
    assert got["num_instances"] > 256


@pytest.mark.parametrize("checker", [0, 1])
def test_gather_shards_gradcheck(checker):
    """The gather's backward sums every rank's cotangent of a shard's rows
    onto its owner once: gradcheck in f64 on rank ``checker`` of 2."""
    assert launch.spawn(cases.gather_gradcheck, 2, device="cpu",
                        timeout_s=TIMEOUT_S, args=(checker,)) == [True, True]


def test_reduce_scatter_sums_in_rank_order():
    """The gather's backward sums the ranks' blocks in rank order on the
    owner, so NCCL and gloo give the same bits (their own reduce-scatters
    sum in orders of their own): at 4 ranks every rank's rows equal
    ((x_0 + x_1) + x_2) + x_3 bit for bit, on values where the reverse
    order rounds otherwise."""
    got = launch.spawn(cases.reduce_scatter_order, 4, device="cpu",
                       timeout_s=TIMEOUT_S, args=(256,))
    assert all(equal for equal, _ in got), got
    assert sum(parted for _, parted in got) > 0, got


def test_capacity_must_divide_by_the_ranks(start):
    state, *_ = cases.step_inputs(*start, "cpu")
    from rain_tpu_torch.parallel import sharding
    with pytest.raises(ValueError, match="not divisible by 3"):
        sharding.shard_state(state, 0, 3)


def test_band_at_negative_offset_equals_the_shifted_band():
    """Band 0's tile offset is -grid_x: its first tile row lies above the
    image. A band whose rects start there, at offset -grid_x, gives the
    bits of the same band moved down one tile row at offset 0 (means on a
    1/64-pixel grid, so the move is exact): B1's columns and keys,
    tile_ranges (y0 = tile_offset // grid_x), B3's tiles and B4's
    gradients, through the plain versions here (the kernels on the card:
    tests/test_torch_cuda.py)."""
    gx = 6
    neg = cases.run_band(cases.band_case(), -gx)
    pos = cases.run_band(cases.band_case(shift_rows=1), 0)
    counts = (neg["end"] - neg["start"]).view(-1, gx)
    assert int(counts[0].sum()) > 0          # instances in row -1
    assert int((neg["tiles"][:gx, :, 6] > 0).sum()) > 0
    live = int(neg["end"][-1])
    for k in ("cols", "pack"):
        a = neg[k][:, :live].clone()
        a[4] += 16.0                          # ROW_YG, 16 pixels down
        assert torch.equal(a, pos[k][:, :live]), k
    for k in ("keys", "start", "end", "tiles", "d_pack"):
        assert torch.equal(neg[k], pos[k]), k


def test_colour_and_covariance_overrides():
    """render's colors_override and cov3d_override: the computed values
    passed as overrides give the same bits; other colours change the
    colour channels and nothing of the geometry."""
    from rain_tpu_torch.ops import projection, render, sh
    rng = np.random.default_rng(3)
    n = 120
    xyz = torch.from_numpy(np.concatenate([
        rng.uniform(-0.8, 0.8, (n, 2)), rng.uniform(2.5, 5.0, (n, 1))],
        1).astype(np.float32))
    scales = torch.from_numpy(np.exp(rng.uniform(-4, -2.5, (n, 3))).astype(
        np.float32))
    q = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    quats = q / q.norm(dim=1, keepdim=True)
    opac = torch.from_numpy(rng.uniform(0.2, 0.9, n).astype(np.float32))
    shs = torch.from_numpy(rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32))
    alive = torch.ones(n, dtype=torch.bool)
    cam = cases.camera("cpu")
    kw = dict(camera=cam, width=cases.W, height=cases.H, sh_degree=3,
              bg=torch.zeros(3), max_instances=4096)
    base = render.render(xyz, scales, quats, opac, shs, alive, **kw)
    same = render.render(
        xyz, scales, quats, opac, shs, alive,
        colors_override=sh.sh_to_rgb(3, shs, xyz, cam["camera_center"]),
        cov3d_override=projection.quat_scale_to_cov3d(scales, quats), **kw)
    for f in base._fields:
        assert torch.equal(getattr(base, f), getattr(same, f)), f
    grey = render.render(xyz, scales, quats, opac, shs, alive,
                         colors_override=torch.full((n, 3), 0.5), **kw)
    assert not torch.equal(grey.render, base.render)
    for f in ("alpha", "final_t", "n_contrib", "radii", "num_instances"):
        assert torch.equal(getattr(grey, f), getattr(base, f)), f
