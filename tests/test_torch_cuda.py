"""Kernels against their plain versions on a CUDA card (skipped without).

Run on a machine with a card: ``python -m pytest tests/test_torch_cuda.py``.
chip_smoke.py makes the same checks at the main path's full shapes.
"""

import contextlib
import gc
import types

import numpy as np
import pytest
import torch

from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import knn as knn_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.scripts import knn_deviation, probe_scale
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step
from torch_expand_cases import CASES, expand_case
from torch_reduce_cases import CASES as REDUCE_CASES
from torch_step_kernels import compare_backward, compare_forward
from torch_reduce_cases import reduce_case
import torch_round_cases as rounds

torch.set_num_threads(1)

W, H, M = 160, 112, 1 << 14
GX, GY = (W + 15) // 16, (H + 15) // 16
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(device, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(2, 8, (n, 1))], 1)
    return gmod.from_arrays(
        xyz, rng.normal(0, 0.5, (n, 1, 3)), rng.normal(0, 0.1, (n, 15, 3)),
        rng.uniform(-4.5, -3, (n, 3)), rng.normal(size=(n, 4)),
        rng.normal(0, 1.5, (n, 1)), device=device)


def _camera(device):
    return Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                  fovx=1.0, fovy=0.7, image=None, width=W,
                  height=H).render_inputs(device)


def test_kernels_match_plain_versions(cuda):
    seen = {}
    step.eval_render(_state(cuda), _camera(cuda), torch.zeros(3, device=cuda),
                     0.3, width=W, height=H, sh_degree=3, max_instances=M,
                     on_stage=seen.__setitem__)
    d = seen["depth_sort"]
    cols_p, keys_p = expand_ops.expand_instances_torch(
        d.table, d.tiles, d.offs, d.rect_w, d.rect_base, grid_x=GX,
        tile_offset=0, n_tiles=GX * GY, max_instances=M)
    cols, keys = seen["expand_B1"]
    assert torch.equal(keys, keys_p)
    assert torch.equal(cols.view(torch.int32), cols_p.view(torch.int32))

    start, end = seen["tile_ranges"]
    tiles = seen["composite_B3"]
    tiles_p = tile_render.composite_forward_torch(
        seen["tile_sort_gather"], start, end, 0, GX)
    # bit for bit: B3's culling skips only pairs that the plain loop skips
    assert torch.equal(tiles.view(torch.int32), tiles_p.view(torch.int32))
    assert int(tiles[..., tile_render.CH_NCONTRIB].max()) > 0


@pytest.mark.parametrize("case", CASES)
def test_b1_edge_cases_match_plain_version(cuda, case):
    args, kw = expand_case(case, 3000, 16_384)
    args = [a.to(cuda) for a in args]
    # NaN in the allocator's cache first, so that a column or key B1
    # failed to write shows
    junk = torch.full((12 * kw["max_instances"] + 8192,), float("nan"),
                      device=cuda)
    del junk
    cols, keys = expand_ops.expand_instances(*args, **kw)
    cols_p, keys_p = expand_ops.expand_instances_torch(*args, **kw)
    assert torch.equal(keys, keys_p)
    # bit for bit, signed zeros and NaNs included
    assert torch.equal(cols.view(torch.int32), cols_p.view(torch.int32))


def test_eval_render_on_card_matches_cpu(cuda):
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    got = step.eval_render(_state(cuda), _camera(cuda),
                           torch.zeros(3, device=cuda), 0.3, **kw)
    want = step.eval_render(_state("cpu"), _camera("cpu"), torch.zeros(3),
                            0.3, **kw)
    for f in ("render", "final_t", "alpha"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=1e-4, atol=3e-5)
    assert int(got.num_instances) == int(want.num_instances) > 0
    assert torch.equal(got.radii.cpu(), want.radii)


def _train(device, state=None, seen=None):
    if state is None:
        state = _state(device)
    if seen is None:
        seen = {}
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, H, W)).astype(np.float32)).to(device)
    return step.train_step(
        state, adam_mod.init(state.params), _camera(device), gt,
        torch.zeros(3, device=device), 0.3, 1.6e-4, width=W, height=H,
        sh_degree=3, max_instances=M, opt_cfg_leaves=OPT,
        on_stage=seen.__setitem__)


def test_backward_kernels_match_plain_versions(cuda):
    seen = {}
    _train(cuda, seen=seen)
    d_rank, exc, tiles, d_depth = seen["reduce_B2"]
    want = expand_ops.reduce_instances_torch(d_rank, exc, tiles)
    assert torch.equal(d_depth, want)
    assert float(want.abs().max()) > 0.0
    args, d_pack = seen["composite_bwd_B4"]
    want = tile_render.composite_backward_torch(*args)
    # bit for bit in every row: B4 sums in the plain version's order
    assert torch.equal(d_pack.view(torch.int32), want.view(torch.int32))
    assert torch.all(d_pack[9:] == 0.0)
    assert float(d_pack[tile_render.ROW_OP].abs().max()) > 0.0


def test_b4_writes_every_element_of_its_output(cuda):
    # B4's output is allocated with torch.empty: fill the allocator's
    # cache with NaN first, so that a column B4 failed to write shows
    seen = {}
    _train(cuda, seen=seen)
    args, _ = seen["composite_bwd_B4"]
    pack, starts, ends = args[:3]
    for _ in range(3):
        junk = torch.full_like(pack, float("nan"))
        del junk
        d_pack = tile_render.composite_backward(*args)
        assert not bool(torch.isnan(d_pack).any())
        assert torch.all(d_pack[tile_render.GRAD_ROWS:] == 0.0)
        assert torch.all(d_pack[:, int(ends[-1]):] == 0.0)


@pytest.mark.parametrize("case", REDUCE_CASES)
def test_b2_edge_cases_match_plain_version(cuda, case):
    d, exc, tiles = (a.to(cuda) for a in reduce_case(case, 3000, 16_384))
    got = expand_ops.reduce_instances(d, exc, tiles)
    want = expand_ops.reduce_instances_torch(d, exc, tiles)
    # bit for bit, signed zeros included: B2 sums in the plain order
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_b2_writes_every_element_of_its_output(cuda):
    # B2's output is allocated with torch.empty: fill the allocator's
    # cache with NaN first, so that an element B2 failed to write shows,
    # on a step's inputs and on a tail of Gaussians with no instance
    seen = {}
    _train(cuda, seen=seen)
    inputs = [seen["reduce_B2"][:3],
              [a.to(cuda) for a in reduce_case("culled_tail", 3000, 16_384)]]
    for d, exc, tiles in inputs:
        for _ in range(3):
            junk = torch.full((d.shape[0] * exc.shape[0] + 8192,),
                              float("nan"), device=cuda)
            del junk
            out = expand_ops.reduce_instances(d, exc, tiles)
            assert not bool(torch.isnan(out).any())
            assert torch.equal(out, expand_ops.reduce_instances_torch(
                d, exc, tiles))


# --- depth regularization: B4's depth variant, B2 at ten rows -------------

def _depth_target(device, k=0, bucket=None):
    """A target inverse depth in [1/8, 1/2], a mask of ones (zero past the
    true size in a bucket) and a weight, unlike for each k."""
    rng = np.random.default_rng(20 + k)
    inv = torch.from_numpy(rng.uniform(0.125, 0.5, (H, W)).astype(
        np.float32)).to(device)
    mask = torch.ones((H, W), device=device)
    if bucket is not None:
        w, h = (int(v) for v in bucket)
        inv[h:] = 0.0
        inv[:, w:] = 0.0
        mask[h:] = 0.0
        mask[:, w:] = 0.0
    return step.DepthTarget(inv, mask, 1.0 - 0.01 * k)


def _train_depth(device, state=None, seen=None):
    if state is None:
        state = _state(device)
    if seen is None:
        seen = {}
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, H, W)).astype(np.float32)).to(device)
    return step.train_step(
        state, adam_mod.init(state.params), _camera(device), gt,
        torch.zeros(3, device=device), 0.3, 1.6e-4, width=W, height=H,
        sh_degree=3, max_instances=M, opt_cfg_leaves=OPT,
        on_stage=seen.__setitem__, depth=_depth_target(device))


def test_depth_backward_kernels_match_plain_versions(cuda):
    """A depth-regularized step: B2 at ten rows and B4's depth variant
    equal their plain versions bit for bit on the step's inputs, the
    tenth row is live, and B4 writes every element of its output."""
    seen = {}
    _train_depth(cuda, seen=seen)
    d_rank, exc, tiles, d_depth = seen["reduce_B2"]
    assert d_rank.shape[0] == tile_render.DEPTH_GRAD_ROWS
    want = expand_ops.reduce_instances_torch(d_rank, exc, tiles)
    assert torch.equal(d_depth.view(torch.int32), want.view(torch.int32))
    assert float(want[tile_render.ROW_DEPTH].abs().max()) > 0.0
    args, d_pack = seen["composite_bwd_B4"]
    want = tile_render.composite_backward_torch(*args, depth=True)
    assert torch.equal(d_pack.view(torch.int32), want.view(torch.int32))
    assert float(d_pack[tile_render.ROW_DEPTH].abs().max()) > 0.0
    assert torch.all(d_pack[tile_render.DEPTH_GRAD_ROWS:] == 0.0)
    for _ in range(3):
        junk = torch.full_like(d_pack, float("nan"))
        del junk
        again = tile_render.composite_backward(*args, depth=True)
        assert torch.equal(again.view(torch.int32), d_pack.view(torch.int32))


@pytest.mark.parametrize("case", REDUCE_CASES)
def test_b2_at_ten_rows_matches_plain_version(cuda, case):
    d, exc, tiles = (a.to(cuda) for a in reduce_case(case, 3000, 16_384))
    d = torch.cat([d, -0.5 * d[:1]]).contiguous()
    got = expand_ops.reduce_instances(d, exc, tiles)
    want = expand_ops.reduce_instances_torch(d, exc, tiles)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_depth_step_on_card_matches_cpu(cuda):
    sc, oc, ac = _train_depth(cuda)
    sh, oh, ah = _train_depth("cpu")
    torch.testing.assert_close(ac.loss.cpu(), ah.loss, rtol=1e-5, atol=0.0)
    assert int(ac.num_instances) == int(ah.num_instances) > 0
    err = (ac.inv_depth.cpu() - ah.inv_depth).abs().max()
    assert float(err) <= 1e-5 * float(ah.inv_depth.abs().max())
    for mc, mh in zip(oc.mu, oh.mu):
        err = (mc.cpu() - mh).abs().max()
        assert float(err) <= 1e-4 * float(mh.abs().max())


# --- the SSIM map's kernels SF and SB (ops/losses.py, csrc/ssim.cu) --------

# 1297x840, its 1312x848 bucket, a band of the four-rank layout at
# 1297x840 (14 tile rows and a halo row a side, 82 tiles wide:
# parallel/sharding.py), 7x5 (under the window) and N = 2
SSIM_SHAPES = [(3, 840, 1297), (3, 848, 1312), (3, 256, 1312), (3, 5, 7),
               (2, 3, 40, 56)]


def _ssim_inputs(shape, device, seed=0):
    """A render-like image, a noisy target and a map cotangent."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    d = rng.normal(size=(1,) * (4 - len(shape)) + shape).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, b, d)]


@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_forward_kernel_equals_plain_bits(cuda, shape):
    a, b, _ = _ssim_inputs(shape, cuda)
    n0 = loss_ops.ssim_map.launches_fwd
    got = loss_ops.ssim_map(a, b)
    assert loss_ops.ssim_map.launches_fwd == n0 + 1
    want = loss_ops.ssim_map_plain(a, b)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_backward_kernel_matches_autograd(cuda, shape):
    """SB against autograd through ssim_map_plain: within 1e-6 of the f64
    gradient, or, where the plain version's f32 moments put autograd's own
    f32 gradient further off it, within twice that (the CPU tests measure
    both at 1.2-1.8e-6 on such images); two runs bitwise equal."""
    a, b, d = _ssim_inputs(shape, cuda, seed=1)

    def grad(fn, dtype):
        x = a.to(dtype).requires_grad_(True)
        return torch.autograd.grad(fn(x, b.to(dtype)), x,
                                   d.to(dtype))[0].double()

    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())

    n0 = loss_ops.ssim_map.launches_bwd
    got = grad(loss_ops.ssim_map, torch.float32)
    assert loss_ops.ssim_map.launches_bwd == n0 + 1
    exact = grad(loss_ops.ssim_map_plain, torch.float64)
    plain = grad(loss_ops.ssim_map_plain, torch.float32)
    assert gap(got, exact) <= max(2 * gap(plain, exact), 1e-6)
    again = grad(loss_ops.ssim_map, torch.float32)
    assert torch.equal(got, again)


def test_ssim_kernels_write_every_element(cuda):
    for shape in SSIM_SHAPES:
        a, b, d = (t.reshape((-1,) + t.shape[-3:]) for t in
                   _ssim_inputs(shape, cuda, seed=2))
        # NaN in the allocator's cache first, so that an element SF or SB
        # failed to write shows
        junk = torch.full((8 * a.numel() + 8192,), float("nan"),
                          device=cuda)
        del junk
        out = loss_ops.ssim_forward(a, b)
        junk = torch.full((8 * a.numel() + 8192,), float("nan"),
                          device=cuda)
        del junk
        d_img1 = loss_ops.ssim_backward(a, b, d, out[1:])
        for t in (*out, d_img1):
            assert t.shape == a.shape and bool(torch.isfinite(t).all())


def test_ssim_map_rejects_what_the_kernels_do_not_take(cuda):
    a, b, _ = _ssim_inputs((3, 16, 20), cuda)
    for args in ((a, b.clone().requires_grad_(True)), (a.half(), b.half()),
                 (a.transpose(1, 2), b.transpose(1, 2)), (a, b.cpu())):
        with pytest.raises(ValueError):
            loss_ops.ssim_map(*args)
    with pytest.raises(ValueError):
        loss_ops.ssim_map(a, b, window_size=7)


# --- Adam's kernel AD (model/adam.py, csrc/adam.cu) -------------------

# a row of each GaussianParams leaf
ADAM_LEAF_SHAPES = ((3,), (1, 3), (15, 3), (3,), (4,), (1,))


def _adam_inputs(device, cap, step, seed=0):
    """Seeded params, gradients and moments of ``cap`` rows at step count
    ``step - 1``, the last quarter of the rows dead (zero gradients and
    moments)."""
    rng = np.random.default_rng(seed)
    alive = cap - cap // 4

    def leaves(scale, fn=lambda x: x, dead=True):
        out = []
        for shape in ADAM_LEAF_SHAPES:
            x = fn(rng.normal(0, scale, (cap,) + shape)).astype(np.float32)
            if dead:
                x[alive:] = 0.0
            out.append(torch.from_numpy(x).to(device))
        return gmod.GaussianParams(*out)

    opt = adam_mod.AdamState(
        mu=leaves(0.1), nu=leaves(0.01, np.square),
        step=torch.full((), step - 1, dtype=torch.int32, device=device))
    return leaves(1.0, dead=False), leaves(1.0), opt, alive


def _adam_flat(params, opt):
    return list(params) + list(opt.mu) + list(opt.nu) + [opt.step]


def _same_bits(a, b):
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _adam_lrs(kind, device):
    """The step's learning rates as numbers, as 0-d f32 tensors on the
    card, or as 0-d f32 tensors in host memory."""
    if kind == "number":
        return adam_mod.learning_rates(types.SimpleNamespace(**OPT), 1.6e-4)
    return step.learning_rates(OPT, 1.6e-4, device if kind == "device"
                               else torch.device("cpu"))


@pytest.mark.parametrize("lr_kind", ["number", "device", "host"])
@pytest.mark.parametrize("step_count", [1, 1000])
@pytest.mark.parametrize("cap", [1, 3, 4097, 262144])
def test_adam_kernel_equals_plain_bits(cuda, cap, step_count, lr_kind):
    """AD's p', m' and v' equal update_plain's on the card bit for bit, at
    capacities whose leaves end off a multiple of 4 and of a block; the
    inputs are left untouched, dead rows stay exactly unchanged and the
    call counts one launch."""
    params, grads, opt, alive = _adam_inputs(cuda, cap, step_count)
    lrs = _adam_lrs(lr_kind, cuda)
    given = _adam_flat(params, opt) + list(grads)
    before = [t.clone() for t in given]
    n0 = adam_mod.update.launches
    got = adam_mod.update(params, grads, opt, lrs)
    assert adam_mod.update.launches == n0 + 1
    want = adam_mod.update_plain(params, grads, opt, lrs)
    assert all(_same_bits(a, b) for a, b in zip(_adam_flat(*got),
                                                _adam_flat(*want)))
    assert all(_same_bits(a, b) for a, b in zip(given, before))
    for a, b in zip(got[0], params):
        assert _same_bits(a[alive:], b[alive:])
    assert int(got[1].step) == step_count


def test_compiled_step_adam_equals_plain_update(cuda):
    """Three calls of CompiledStep.train_step, the first its capture, each
    with another xyz_lr and a step count one higher: the parameters and
    moments each call returns equal update_plain's over the gradients of
    the eager step fed the same tensors, bit for bit, and each call counts
    one launch of AD."""
    steps = compiled.CompiledStep()
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    leaves = {k: torch.full((), v, device=cuda) for k, v in OPT.items()}
    for k in range(3):
        x = _step_inputs(cuda, k, False)
        st = state._replace(n_alive=x["n_alive"])
        args = (st, opt, x["camera"], x["gt"], x["bg"], x["low_pass"],
                x["xyz_lr"])
        kw = dict(width=W, height=H, sh_degree=3, max_instances=M,
                  opt_cfg_leaves=leaves)
        seen = {}
        step.train_step(*args, **kw, on_stage=seen.__setitem__)
        want = adam_mod.update_plain(
            seen["densify_stats"].params, seen["grads"][0], opt,
            step.learning_rates(leaves, x["xyz_lr"], cuda))
        n0 = adam_mod.update.launches
        got = steps.train_step(*args, **kw)
        assert adam_mod.update.launches == n0 + 1
        assert all(_same_bits(a, b) for a, b in zip(
            _adam_flat(got[0].params, got[1]), _adam_flat(*want)))
        assert int(got[1].step) == k + 1
        state, opt = got[0], got[1]
    assert len(steps.captures) == 1


@pytest.mark.parametrize("real_wh", [None, (150, 100)])
def test_train_step_makes_no_synchronising_call(cuda, real_wh):
    """train_step queues its work and returns: no call in it waits for the
    card (sync debug mode raises at any), bucketed or not."""
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    cam, bg = _camera(cuda), torch.zeros(3, device=cuda)
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, H, W)).astype(np.float32)).to(cuda)
    if real_wh is not None:
        gt[:, real_wh[1]:] = 0.0
        gt[:, :, real_wh[0]:] = 0.0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step.train_step(
            state, opt, cam, gt, bg, 0.3, 1.6e-4, width=W, height=H,
            sh_degree=3, max_instances=M, opt_cfg_leaves=OPT,
            real_wh=real_wh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out[2].loss))


def test_step_scalars_equal_host_copies(cuda):
    """The device fills that replaced host copies in train_step hold the
    same bits: the learning rates (and feature_lr / 20 on the card), the
    statistics' NDC scale and the masked loss's pixel count."""
    for v in list(OPT.values()) + [1.6e-4, 0.1, 1.0 / 3.0]:
        old = torch.tensor(v, dtype=torch.float32, device=cuda)
        new = torch.full((), v, dtype=torch.float32, device=cuda)
        assert torch.equal(old.view(torch.int32), new.view(torch.int32))
        assert torch.equal((old / 20.0).view(torch.int32),
                           (new / 20.0).view(torch.int32))
    tap = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1e-3, (500, 2)).astype(np.float32)).to(cuda)
    radii = torch.ones(500, dtype=torch.int32, device=cuda)
    for w, h in ((W, H), (1297, 840), (150, 100)):
        old = torch.tensor([0.5 * w, 0.5 * h], dtype=torch.float32,
                           device=cuda)
        s = tap * old[None, :]
        want = torch.sqrt(torch.sum(s * s, dim=-1))
        st = densify_mod.add_densification_stats(
            _state(cuda, n=500), tap, radii, w, h)
        assert torch.equal(st.xyz_gradient_accum, want)
        n_pix = (3.0 * torch.tensor(h, dtype=torch.float32, device=cuda) *
                 torch.tensor(w, dtype=torch.float32, device=cuda))
        img = torch.rand((3, 112, 160), device=cuda)
        ref = torch.zeros_like(img)
        mask = torch.zeros_like(img)
        mask[:, :min(h, 112), :min(w, 160)] = 1.0
        ll1 = torch.sum(torch.abs(img * mask - ref)) / n_pix
        _, got = loss_ops.masked_training_loss(img, ref, w, h)
        assert torch.equal(got, ll1)


def test_train_step_on_card_is_bitwise_reproducible(cuda):
    state = _state(cuda)
    (s1, o1, a1), (s2, o2, a2) = _train(cuda, state), _train(cuda, state)
    assert torch.equal(a1.loss, a2.loss)
    for x, y in zip(list(s1.params) + list(o1.mu) + list(o1.nu),
                    list(s2.params) + list(o2.mu) + list(o2.nu)):
        assert torch.equal(x, y)
    for k in gmod.STAT_FIELDS:
        assert torch.equal(getattr(s1, k), getattr(s2, k))


def test_train_step_on_card_matches_cpu(cuda):
    sc, oc, ac = _train(cuda)
    sh, oh, ah = _train("cpu")
    torch.testing.assert_close(ac.loss.cpu(), ah.loss, rtol=1e-5, atol=0.0)
    assert int(ac.num_instances) == int(ah.num_instances) > 0
    for mc, mh in zip(oc.mu, oh.mu):
        err = (mc.cpu() - mh).abs().max()
        assert float(err) <= 1e-4 * float(mh.abs().max())


def test_wrappers_reject_wrong_inputs(cuda):
    pack = torch.zeros((16, 256), device=cuda)
    starts = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        tile_render.composite_forward(pack, starts, starts, 0, 2)
    with pytest.raises(ValueError):
        expand_ops.reduce_instances(pack, starts.int(), starts.int())


def test_knn_on_card_matches_cpu(cuda):
    """The exact search at 3000 points and the window search, the card
    against the CPU: the same candidates and the same f32/f64 operations,
    so rtol 1e-6 holds with room (the matmul that picks the candidates
    rounds differently in cuBLAS)."""
    pts = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3000, 3)).astype(np.float32))
    for fn in (knn_ops.mean_dist3_auto, knn_ops.mean_dist3):
        got = fn(pts.to(cuda)).cpu()
        torch.testing.assert_close(got, fn(pts), rtol=1e-6, atol=0.0)


def test_densify_on_card_matches_cpu(cuda):
    """One densify round on the card and on the CPU from the same state
    and noise: the same DensifyInfo and n_alive, values to rtol 1e-6
    (exp, log and sigmoid may round an ulp apart)."""
    rng = np.random.default_rng(6)
    infos, states = [], []
    for dev in (cuda, torch.device("cpu")):
        state = _state(dev, n=600, seed=3)
        cap = state.capacity
        state = gmod.grow_capacity(state, 2 * cap)
        g = torch.from_numpy(np.random.default_rng(7).uniform(
            0, 4e-4, cap).astype(np.float32))
        state.xyz_gradient_accum[:cap] = g.to(dev)
        state.denom[:cap] = 1.0
        noise = torch.from_numpy(rng.normal(size=(2, 2 * cap, 3)).astype(
            np.float32)) if not states else states[0][2]
        s, o, info = densify_mod.densify_and_prune(
            state, adam_mod.init(state.params), noise.to(dev),
            max_grad=2e-4, min_opacity=0.005, extent=4.0,
            percent_dense=0.01, divide_ratio=0.8, abe_split=True)
        infos.append(info)
        states.append((s, o, noise))
    assert infos[0] == infos[1] and infos[0].n_split > 0
    for a, b in zip(states[0][0].params, states[1][0].params):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)


def test_trainer_pipeline_is_bitwise_on_card(cuda, tmp_path):
    """system.pipeline 1 against 0 on the card, across an overflow retry
    and a densify round: the same bits."""
    from test_torch_trainer_port import configs, make_scene
    from rain_tpu_torch.train.trainer import Trainer
    scene = make_scene(n_pts=400, size=64)
    runs = []
    for pipeline in (1, 0):
        cfgs = configs(dict(iterations=12, densify_from_iter=4,
                            densification_interval=6,
                            opacity_reset_interval=10_000),
                       dict(capacity=2048, max_instances=512,
                            pipeline=pipeline))
        tr = Trainer(scene, cfgs, str(tmp_path / str(pipeline)),
                     device=cuda, log_fn=lambda *a: None, tensorboard=False)
        tr.train(iterations=12, test_iterations=(), save_iterations=())
        runs.append(tr)
    a, b = runs
    assert a.state.params.xyz.is_cuda and a.max_instances > 512
    assert (a.state.n_alive, a.max_instances) == (b.state.n_alive,
                                                  b.max_instances)
    for x, y in zip(list(a.state.params) + list(a.opt_state.mu),
                    list(b.state.params) + list(b.opt_state.mu)):
        assert torch.equal(x, y)


def test_train_and_render_cli_on_card_match_cpu(cuda, tmp_path):
    """The train CLI (10 iterations, a report at 10) and the render CLI on
    the toy COLMAP scene, on the card and with --device cpu: the reports
    at rtol 1e-4 (tests/test_torch_cli.py's bar against rain_tpu), and the
    render CLI's PNGs of one PLY within 1 LSB of each other."""
    import json
    import shutil
    from rain_tpu_torch.data import images
    from rain_tpu_torch.scripts import render as render_cli
    from rain_tpu_torch.scripts import train as train_cli
    from torch_colmap_scene import toy_scene
    scene = tmp_path / "scene"
    toy_scene(scene)
    reports = []
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        train_cli.main(["-s", str(scene), "-m", str(out), "--iterations",
                        "10", "--test_iterations", "10", "--num_cams", "3",
                        "--capacity", "400", "--max_instances", "262144",
                        "--resolution", "1", "--quiet", "--device", dev])
        reports.append(json.loads(
            (out / "log_file.txt").read_text().splitlines()[-1]))
    for split in ("test", "train"):
        for k in ("l1", "psnr", "ssim"):
            np.testing.assert_allclose(reports[0][split][k],
                                       reports[1][split][k], rtol=1e-4)
    shutil.copytree(tmp_path / "cuda", tmp_path / "render_cpu")
    render_cli.main(["-m", str(tmp_path / "cuda")])
    render_cli.main(["-m", str(tmp_path / "render_cpu"), "--device", "cpu"])
    names = sorted(p.relative_to(tmp_path / "cuda")
                   for p in (tmp_path / "cuda").rglob("*.png"))
    assert len(names) == 4 * 6
    for name in names:
        a = images.load(tmp_path / "cuda" / name).astype(int)
        b = images.load(tmp_path / "render_cpu" / name).astype(int)
        assert np.abs(a - b).max() <= 1, name


def test_entry_on_card_matches_cpu(cuda):
    from rain_tpu_torch import entry as entry_mod
    fn, args = entry_mod.entry()
    got = fn(*args)
    assert got.device.type == "cuda"
    fn_c, args_c = entry_mod.entry("cpu")
    torch.testing.assert_close(got.cpu(), fn_c(*args_c), rtol=1e-4,
                               atol=3e-5)


def test_band_kernels_at_negative_offset_match_plain_versions(cuda):
    """B1, B3 and B4 at tile offset -grid_x (the sharded step's band 0),
    on a band whose rects start in the row above the image: bit for bit
    with their plain versions (which floor-divide the global tile id), and
    with the same band moved down one row at offset 0."""
    import torch_sharding_cases as cases
    gx = 6
    case = cases.band_case()
    got = cases.run_band(case, -gx, device=cuda)
    want = cases.run_band(case, -gx, plain=True, device=cuda)
    assert int((got["tiles"][:gx, :, tile_render.CH_NCONTRIB] > 0).sum()) > 0
    for k in got:
        a, b = got[k], want[k]
        if a.is_floating_point():     # bit for bit, signed zeros included
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    moved = cases.run_band(cases.band_case(shift_rows=1), 0, device=cuda)
    for k in ("keys", "start", "end", "tiles", "d_pack"):
        assert torch.equal(got[k], moved[k]), k


def test_colors_override_on_card_matches_cpu(cuda):
    """render's colors_override on the card: the CPU path's image at the
    forward bar, and the SH colours passed as the override give the
    render's own bits."""
    from rain_tpu_torch.ops import render as render_ops
    from rain_tpu_torch.ops import sh as sh_ops
    outs = []
    for dev in (cuda, torch.device("cpu")):
        st = _state(dev)
        scales, quats, opac, shs = gmod.activate(st.params)
        kw = dict(camera=_camera(dev), width=W, height=H, sh_degree=3,
                  bg=torch.zeros(3, device=dev), max_instances=M)
        colours = torch.linspace(0, 1, 3 * st.capacity,
                                 device=dev).view(-1, 3)
        outs.append(render_ops.render(
            st.params.xyz, scales, quats, opac, shs, gmod.alive_mask(st),
            colors_override=colours, **kw).render)
        if dev.type == "cuda":
            base = render_ops.render(st.params.xyz, scales, quats, opac, shs,
                                     gmod.alive_mask(st), **kw)
            same = render_ops.render(
                st.params.xyz, scales, quats, opac, shs, gmod.alive_mask(st),
                colors_override=sh_ops.sh_to_rgb(
                    3, shs, st.params.xyz, kw["camera"]["camera_center"]),
                **kw)
            assert torch.equal(base.render, same.render)
    torch.testing.assert_close(outs[0].cpu(), outs[1], rtol=1e-4, atol=3e-5)


def test_sharded_step_on_shared_card_matches_train_step(cuda):
    """Two gloo ranks sharing the card (gloo takes the CUDA tensors)
    against train_step on the card, at tests/test_sharding.py:60-76's
    bars, and a rerun's bits."""
    import torch_sharding_cases as cases
    from rain_tpu_torch.parallel import launch
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (80, 2)),
                          rng.uniform(2.5, 5.0, (80, 1))], 1).astype(
        np.float32)
    st = gmod.create_from_pcd(pts, rng.uniform(0, 1, (80, 3)).astype(
        np.float32), sh_degree=3, capacity=128, knn_window=16, device="cpu")
    start = ({k: v.numpy() for k, v in st.params._asdict().items()},
             st.n_alive)
    state, opt, cam, gt, bg = cases.step_inputs(*start, cuda)
    s, o, aux = step.train_step(
        state, opt, cam, gt, bg, cases.LOW_PASS,
        torch.tensor(cases.XYZ_LR, device=cuda), width=cases.W,
        height=cases.H, sh_degree=3, max_instances=4096,
        opt_cfg_leaves=cases.OPT_LEAVES)
    want = cases._numpy(s, o, aux)
    runs = [launch.spawn(cases.sharded_step, 2, device="cuda",
                         share_device=True, timeout_s=300,
                         args=(*start, 4096))[0] for _ in range(2)]
    got = runs[0]
    assert abs(got["loss"] - want["loss"]) < 1e-5
    assert abs(got["l1"] - want["l1"]) < 1e-5
    for group in ("params", "mu", "nu"):
        for name, a in got[group].items():
            assert np.abs(a - want[group][name]).max() < 1e-5, (group, name)
    np.testing.assert_allclose(got["stats"]["xyz_gradient_accum"],
                               want["stats"]["xyz_gradient_accum"],
                               atol=1e-5, rtol=0)
    for name in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(got["stats"][name],
                                      want["stats"][name])
    assert cases.digest(runs[0]) == cases.digest(runs[1])


def test_1m_tier_step0_matches_plain_versions_and_cpu_count(cuda):
    """bench.py's 1m tier (scripts/probe_scale.py) at step 0 and the tier
    2^21: no overflow, B1-B4 bit for bit against their plain versions
    (tests/torch_step_kernels.py, as chip_smoke.py holds them), and the
    instances the CPU path counts on the same state (which equal
    rain_tpu's per Gaussian, tests/test_torch_scale_tools.py)."""
    n, m, log_scale = probe_scale.TIERS["1m"]
    ts = probe_scale.build_tier_state(n, log_scale, device=cuda)
    seen = {}
    _, _, aux = probe_scale.train_once(ts, ts.state, ts.opt, m,
                                       on_stage=seen.__setitem__)
    assert not bool(aux.instance_overflow)
    compare_forward(seen, probe_scale.WIDTH, probe_scale.HEIGHT, "1m", m)
    compare_backward(seen, "1m")
    assert int(aux.num_instances) == probe_scale.preprocess_instances(
        probe_scale.build_tier_state(n, log_scale, device="cpu"))


def test_window_knn_above_2_20_points_on_card_matches_cpu(cuda):
    """mean_dist3_auto past its exact limit (2^20 + 4096 points of
    knn_deviation's cloud) takes the Morton-window search; on the card it
    equals the CPU's window search at rtol 1e-6 (the same candidates and
    operations)."""
    pts = torch.from_numpy(knn_deviation.cloud((1 << 20) + 4096))
    got = knn_ops.mean_dist3_auto(pts.to(cuda)).cpu()
    torch.testing.assert_close(got, knn_ops.mean_dist3(pts), rtol=1e-6,
                               atol=0.0)


def test_e2e_long_run_on_card_passes_the_tests_assertions(cuda, tmp_path):
    """rain_tpu_torch.scripts.e2e_long at its full 2,500 iterations on the
    card: tests/test_e2e_long.py's five assertions (``main`` checks them
    and raises on the first that fails), and the iteration-0 report
    within one unit of docs/runs/e2e_long_tpu_r4.log's last printed
    digit."""
    from rain_tpu_torch.scripts import e2e_long
    rec = e2e_long.main(["--out", str(tmp_path / "out")])
    assert rec["stop"] == rec["iterations"] == e2e_long.ITERATIONS
    assert not any(rec["gt_overflow"])
    off = e2e_long.units_off(rec["report0"])
    assert max(max(v) for v in off.values()) <= 1, (off, rec["report0"])


# --- the compiled step (train.compiled): CUDA graphs per key ---------------

def _launches():
    return compiled.launch_counts()


def _step_inputs(device, k, bucketed):
    """Step k's inputs, unlike step 0's (the capture's): another camera,
    n_alive, low_pass, xyz_lr, background and, bucketed, true size."""
    rng = np.random.default_rng(10 + k)
    ang = 0.03 * k
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    cam = Camera(uid=k, image_name="t", R=R, T=np.array([0.05 * k, 0, 0]),
                 fovx=1.0, fovy=0.7, image=None, width=W,
                 height=H).render_inputs(device)
    gt = torch.from_numpy(rng.uniform(0, 1, (3, H, W)).astype(
        np.float32)).to(device)
    real_wh = None
    if bucketed:
        w, h = W - 3 * k, H - 2 * k - 1        # all in the bucket W x H
        gt[:, h:] = 0.0
        gt[:, :, w:] = 0.0
        real_wh = tuple(torch.full((), v, dtype=torch.int32, device=device)
                        for v in (w, h))

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    return dict(camera=cam, gt=gt,
                bg=torch.from_numpy(rng.uniform(0, 1, 3).astype(
                    np.float32)).to(device),
                low_pass=f32(0.3 + 0.05 * k), xyz_lr=f32(1.6e-4 / (1 + k)),
                n_alive=torch.full((), 2000 - 37 * k, dtype=torch.int32,
                                   device=device),
                real_wh=real_wh)


def _tensors(out):
    state, opt, aux = out
    return (list(state.params) + [getattr(state, k) for k in
                                  gmod.STAT_FIELDS] +
            list(opt.mu) + list(opt.nu) +
            [opt.step, aux.loss, aux.l1, aux.num_instances,
             aux.instance_overflow])


@pytest.mark.parametrize("bucketed", [False, True])
def test_compiled_train_step_replays_equal_eager(cuda, bucketed):
    """Six chained steps, the first captured: every replay on inputs
    unlike the capture's equals the eager train_step fed the same tensors,
    bit for bit; the inputs are left untouched; B1-B4's, preprocess's
    two kernels', the SSIM map's two and Adam's counters count one launch
    per call, replays included."""
    steps = compiled.CompiledStep()
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    leaves = {k: torch.full((), v, device=cuda) for k, v in OPT.items()}
    for k in range(6):
        x = _step_inputs(cuda, k, bucketed)
        st = state._replace(n_alive=x["n_alive"])
        args = (st, opt, x["camera"], x["gt"], x["bg"], x["low_pass"],
                x["xyz_lr"])
        kw = dict(width=W, height=H, sh_degree=3, max_instances=M,
                  opt_cfg_leaves=leaves, real_wh=x["real_wh"],
                  update_densify_stats=k != 3)
        given = (list(st.params) + [getattr(st, f) for f in
                                    gmod.STAT_FIELDS] +
                 list(opt.mu) + list(opt.nu) + [opt.step] +
                 list(x["camera"].values()) +
                 [x[f] for f in ("gt", "bg", "low_pass", "xyz_lr",
                                 "n_alive")])
        before = [t.clone() for t in given]
        want = step.train_step(*args, **kw)
        n0 = _launches()
        got = steps.train_step(*args, **kw)
        # one each, B4's depth variant none
        assert [b - a for a, b in zip(n0, _launches())] == [1] * 8 + [0, 1]
        for a, b in zip(_tensors(got), _tensors(want)):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(before, given))
        assert got[0].n_alive is x["n_alive"]
        state, opt = got[0], got[1]
    # update_densify_stats False at step 3 is its own key
    assert len(steps.captures) == 2 and len(steps.graphs) == 2
    assert float(got[2].loss) > 0.0 and not bool(got[2].instance_overflow)


@pytest.mark.parametrize("bucketed", [False, True])
def test_compiled_depth_step_replays_equal_eager(cuda, bucketed):
    """Four chained depth-regularized steps, the first captured into a
    DepthTrainKey's graph: each replay, on inputs and a weight unlike the
    capture's, equals the eager step bit for bit, its inverse depth
    included; B4 and its depth variant count one launch per call."""
    steps = compiled.CompiledStep()
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    for k in range(4):
        x = _step_inputs(cuda, k, bucketed)
        st = state._replace(n_alive=x["n_alive"])
        args = (st, opt, x["camera"], x["gt"], x["bg"], x["low_pass"],
                x["xyz_lr"])
        kw = dict(width=W, height=H, sh_degree=3, max_instances=M,
                  opt_cfg_leaves=OPT, real_wh=x["real_wh"],
                  depth=_depth_target(cuda, k, x["real_wh"]))
        want = step.train_step(*args, **kw)
        b4 = tile_render.composite_backward
        n0 = (b4.launches, b4.launches_depth)
        got = steps.train_step(*args, **kw)
        assert (b4.launches - n0[0], b4.launches_depth - n0[1]) == (1, 1)
        for a, b in zip(_tensors(got), _tensors(want)):
            assert torch.equal(a, b)
        assert torch.equal(got[2].inv_depth, want[2].inv_depth)
        state, opt = got[0], got[1]
    key, = steps.train_keys
    assert isinstance(key, compiled.DepthTrainKey) and key.bucketed == \
        bucketed
    assert len(steps.captures) == 1


def test_no_cyclic_collection_runs_inside_a_capture(cuda):
    """The cyclic collector is off while a graph is captured and on again
    after; the warm-up runs with it on. A collection inside a capture
    could destroy an unreachable graph (a dropped CompiledStep held in a
    reference cycle), which a "global" capture does not permit: the
    capture would fail. The graph replays."""
    seen = []

    def fn(bufs, on_stage):
        seen.append(gc.isenabled())
        return [bufs[0] * 2.0]

    x = torch.arange(4.0, device=cuda)
    g = compiled._Graph(fn, [x], [torch.empty_like(x)], x.device,
                        torch.cuda.graph_pool_handle())
    assert seen == [True, False] and gc.isenabled()
    out = g([x + 1.0], x.device, lambda name: contextlib.nullcontext())
    assert torch.equal(out[0], (x + 1.0) * 2.0)


def test_compiled_eval_render_replays_equal_eager(cuda):
    """Five frames through one graph: another camera, n_alive, low_pass,
    background and scale_modifier each time; each equals the eager
    eval_render bit for bit, and B1, B3 and preprocess's forward count one
    launch per frame."""
    steps = compiled.CompiledStep()
    state = _state(cuda)
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    for k in range(5):
        x = _step_inputs(cuda, k, False)
        st = state._replace(n_alive=x["n_alive"])
        sm = torch.full((), 1.0 - 0.1 * k, device=cuda)
        want = step.eval_render(st, x["camera"], x["bg"], x["low_pass"], sm,
                                **kw)
        n0 = _launches()
        got = steps.eval_render(st, x["camera"], x["bg"], x["low_pass"], sm,
                                **kw)
        # B1, B3 and preprocess's forward; the render runs no SSIM, no Adam
        assert [b - a for a, b in zip(n0, _launches())] == \
            [1, 0, 1, 0, 1, 0, 0, 0, 0, 0]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got.num_instances) > 0
    assert len(steps.captures) == 1


def test_compiled_replay_makes_no_synchronising_call(cuda):
    """After the capture, a compiled train_step and eval_render queue
    their copies and replay and return: sync debug mode raises at any
    call that waits for the card."""
    steps = compiled.CompiledStep()
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    leaves = {k: torch.full((), v, device=cuda) for k, v in OPT.items()}
    for k in range(2):
        x = _step_inputs(cuda, k, True)
        st = state._replace(n_alive=x["n_alive"])
        torch.cuda.synchronize()
        if k:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = steps.train_step(
                st, opt, x["camera"], x["gt"], x["bg"], x["low_pass"],
                x["xyz_lr"], width=W, height=H, sh_degree=3,
                max_instances=M, opt_cfg_leaves=leaves,
                real_wh=x["real_wh"])
            frame = steps.eval_render(st, x["camera"], x["bg"],
                                      x["low_pass"], 0.9, width=W, height=H,
                                      sh_degree=3, max_instances=M)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out[2].loss))
    assert int(frame.num_instances) > 0


def _round_state(device, n=2000, capacity=5000):
    return gmod.grow_capacity(_state(device, n=n), capacity)


@pytest.mark.parametrize("abe_split,use_size_threshold",
                         [(True, False), (False, True)])
def test_compiled_round_and_reset_replay_equal_eager(cuda, abe_split,
                                                     use_size_threshold):
    """A densify round and an opacity reset captured, then replayed at
    other n_alive values with other noise and scalars (the last round's
    appends overflow the capacity): each result equals the eager
    function's on the same inputs bit for bit, the inputs are left
    untouched, and one graph serves each key."""
    steps = compiled.CompiledStep()
    base = _round_state(cuda)
    static = dict(abe_split=abe_split, use_size_threshold=use_size_threshold)
    infos = []
    for k, n_alive in enumerate((2000, 1900, 1713, 2000)):
        st, opt = rounds.seeded(base, n_alive, seed=k)
        noise = rounds.noise(base.capacity, cuda, seed=20 + k)
        over = dict(max_grad=1e-9, percent_dense=1e-4) if k == 3 else {}
        sc = rounds.scalars(k, cuda, extent=5.0, **over)
        given = rounds.leaves(st, opt) + [noise] + list(sc.values())
        before = [t.clone() for t in given]
        want = densify_mod.densify_and_prune(st, opt, noise, **sc, **static)
        got = steps.densify_and_prune(
            st._replace(n_alive=torch.tensor(n_alive, dtype=torch.int32,
                                             device=cuda)),
            opt, noise, **sc, **static)
        assert rounds.same(got, want), k
        assert all(torch.equal(a, b) for a, b in zip(before, given))
        infos.append(got[2])
        want = densify_mod.reset_opacity(st, opt)
        got = steps.reset_opacity(st, opt)
        assert rounds.same(got, want), k
    assert all(i.n_cloned and i.n_split and i.n_pruned for i in infos[:3])
    assert infos[3].overflow and not any(i.overflow for i in infos[:3])
    assert len(steps.graphs) == 2 and len(steps.captures) == 2
    assert steps.densify_keys == {compiled.DensifyKey(
        5000, 2, abe_split, use_size_threshold)}


TRAIN_MARKS = (("begin",) + render_ops.STAGES + ("loss",) +
               render_ops.BACKWARD_STAGES + step.TRAIN_STAGES[1:])
EVAL_MARKS = ("begin",) + render_ops.STAGES


def _marked_calls(cuda, steps, calls=3):
    """A train, an eval, a round and a reset key through ``steps``, each
    captured and replayed ``calls - 1`` times on other inputs, every call
    held to the eager function bit for bit. Returns {kind: key}."""
    state = _state(cuda)
    opt = adam_mod.init(state.params)
    leaves = {k: torch.full((), v, device=cuda) for k, v in OPT.items()}
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    base = _round_state(cuda)
    for k in range(calls):
        x = _step_inputs(cuda, k, False)
        st = state._replace(n_alive=x["n_alive"])
        args = (st, opt, x["camera"], x["gt"], x["bg"], x["low_pass"],
                x["xyz_lr"])
        want = step.train_step(*args, opt_cfg_leaves=leaves, **kw)
        got = steps.train_step(*args, opt_cfg_leaves=leaves, **kw)
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got),
                                                      _tensors(want)))
        want = step.eval_render(st, x["camera"], x["bg"], x["low_pass"],
                                **kw)
        got = steps.eval_render(st, x["camera"], x["bg"], x["low_pass"],
                                **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rs, ro = rounds.seeded(base, 1900 + 50 * k, seed=k)
        noise = rounds.noise(base.capacity, cuda, seed=k)
        sc = rounds.scalars(k, cuda, extent=5.0)
        assert rounds.same(steps.densify_and_prune(rs, ro, noise, **sc),
                           densify_mod.densify_and_prune(rs, ro, noise, **sc))
        assert rounds.same(steps.reset_opacity(rs, ro),
                           densify_mod.reset_opacity(rs, ro))
    return {"train": next(iter(steps.train_keys)),
            "eval": next(iter(steps.eval_keys)),
            "round": next(iter(steps.densify_keys)),
            "reset": next(iter(steps.reset_keys))}


def test_marked_replays_equal_eager_and_read_their_stages(cuda):
    """Every graph carries its stage marks: the replays of a train, an
    eval, a round and a reset key equal the eager results bit for bit
    (``_marked_calls``), each key recorded its marks in order at capture,
    and ``stage_ms`` reads its last replay's intervals by name, each
    >= 0."""
    steps = compiled.CompiledStep()
    keys = _marked_calls(cuda, steps)
    want = {"train": TRAIN_MARKS, "eval": EVAL_MARKS,
            "round": ("begin", "round"), "reset": ("begin", "reset")}
    for kind, key in keys.items():
        assert tuple(steps.graphs[key].marks.names) == want[kind], kind
        ms = steps.stage_ms(key)
        assert tuple(ms) == want[kind][1:], kind
        assert all(v >= 0.0 for v in ms.values()) and sum(ms.values()) > 0
    assert steps.last_step_key == keys["train"]
    # the composite's intervals hold B3's and B4's work
    ms = steps.stage_ms(keys["train"])
    assert ms["composite_B3"] > 0.0 and ms["composite_bwd_B4"] > 0.0


def test_a_profiled_replay_holds_each_mark_once_in_order(cuda, tmp_path):
    """One traced replay of a train and an eval key: the profiler's record
    holds each rain_mark_<stage> kernel once, in the order its key
    recorded, launched by the graph; the call's host spans name its copies
    in and out, and the copies' operations were launched inside them."""
    import json
    from torch.profiler import ProfilerActivity, profile
    steps = compiled.CompiledStep()
    keys = _marked_calls(cuda, steps, calls=2)
    x = _step_inputs(cuda, 5, False)
    state = _state(cuda)._replace(n_alive=x["n_alive"])
    leaves = {k: torch.full((), v, device=cuda) for k, v in OPT.items()}
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps.train_step(state, adam_mod.init(state.params), x["camera"],
                         x["gt"], x["bg"], x["low_pass"], x["xyz_lr"],
                         opt_cfg_leaves=leaves, **kw)
        steps.eval_render(state, x["camera"], x["bg"], x["low_pass"], **kw)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    launched = {e["args"].get("correlation"): e["name"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    found = sorted((e["ts"], e["name"], launched.get(
        e["args"].get("correlation"))) for e in events
        if e.get("cat") == "kernel" and e["name"].startswith("rain_mark_"))
    assert [n for _, n, _ in found] == [
        "rain_mark_" + s for s in
        steps.graphs[keys["train"]].marks.names +
        steps.graphs[keys["eval"]].marks.names]
    assert {how for _, _, how in found} == {"cudaGraphLaunch"}
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("train_step", "eval_render"):
        assert spans.count(compiled.SPAN + name) == 1
    for name in ("copy_in", "replay", "copy_out"):
        assert spans.count(compiled.SPAN + name) == 2
    copies = probe_scale.span_ops(events)
    assert copies and all(n > 0 for _, n in copies.values())
    assert not any(name.startswith("rain_mark_") for name in copies)


def test_compiled_round_waits_only_to_read_its_info(cuda, monkeypatch):
    """A replayed round, under sync debug mode "error" up to the read of
    its info: no call before that read waits for the card, and the read
    is the round's one synchronising call."""
    steps = compiled.CompiledStep()
    base = _round_state(cuda)
    reads = []
    unpack = densify_mod.unpack_info

    def read(info):
        torch.cuda.set_sync_debug_mode("default")
        reads.append(1)
        return unpack(info)

    monkeypatch.setattr(densify_mod, "unpack_info", read)
    for k in range(2):
        st, opt = rounds.seeded(base, 1900 + k, seed=k)
        noise = rounds.noise(base.capacity, cuda, seed=k)
        sc = rounds.scalars(k, cuda, extent=5.0)
        torch.cuda.synchronize()
        if k:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = steps.densify_and_prune(st, opt, noise, **sc,
                                          abe_split=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert reads == [1, 1] and out[2].n_alive == out[0].n_alive > 0


def test_retire_drops_round_graphs_at_a_growth(cuda):
    """Graphs of the round and the reset at a capacity are dropped when
    the capacity grows past it, with their buffers; the pool goes with
    the last graph, and a capture at the grown capacity starts another."""
    steps = compiled.CompiledStep()
    for cap in (4096, 8192):
        st, opt = rounds.seeded(_round_state(cuda, capacity=cap), 2000,
                                seed=cap)
        noise = rounds.noise(cap, cuda, seed=1)
        sc = rounds.scalars(0, cuda, extent=5.0)
        steps.densify_and_prune(st, opt, noise, **sc)
        steps.reset_opacity(st, opt)
        if cap == 4096:
            steps.retire(4096, 1 << 20)        # no growth: kept
            assert len(steps.graphs) == 2
            steps.retire(8192, 1 << 20)
            assert steps.graphs == {} and steps._buffers == {}
            assert steps._pool is None
    assert {k.capacity for k in steps.graphs} == {8192}
    got = steps.densify_and_prune(st, opt, noise, **sc)     # a replay
    assert rounds.same(got, densify_mod.densify_and_prune(st, opt, noise,
                                                          **sc))


def test_failed_capture_raises(cuda, tmp_path):
    """A step that waits for the card inside its capture makes the
    compiled step raise (and keep no graph): nothing carries on eagerly.
    In a process of its own, as a failed capture may leave the CUDA
    context unusable."""
    import subprocess
    import sys
    from pathlib import Path
    script = tmp_path / "fail.py"
    script.write_text(f"""
import sys
sys.path[:0] = [{str(Path(__file__).parent)!r},
                {str(Path(__file__).parent.parent)!r}]
import torch
from rain_tpu_torch.train import compiled, step
from test_torch_cuda import _state, _step_inputs, OPT, W, H, M
from rain_tpu_torch.model import adam as adam_mod

eager = step.train_step

def waits(*a, **kw):
    out = eager(*a, **kw)
    if torch.cuda.is_current_stream_capturing():
        float(out[2].loss)       # a host read: not capturable
    return out

step.train_step = waits
dev = torch.device("cuda")
steps = compiled.CompiledStep()
state = _state(dev)
x = _step_inputs(dev, 0, False)
leaves = {{k: torch.full((), v, device=dev) for k, v in OPT.items()}}
try:
    steps.train_step(state, adam_mod.init(state.params), x["camera"],
                     x["gt"], x["bg"], x["low_pass"], x["xyz_lr"], width=W,
                     height=H, sh_degree=3, max_instances=M,
                     opt_cfg_leaves=leaves)
except RuntimeError as e:      # torch.AcceleratorError is one
    print("raised RuntimeError", len(steps.graphs), flush=True)
    sys.exit(0)
print("did not raise", flush=True)
sys.exit(1)
""")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "raised RuntimeError 0" in out.stdout, \
        out.stdout + out.stderr


def test_trainer_compiled_equals_eager_on_card(cuda, tmp_path, monkeypatch):
    """The Trainer through its compiled step against the same run with
    CompiledStep's methods replaced by the eager step, render, round and
    reset, across an overflow retry, a capacity growth and two densify
    rounds: the same losses, rounds, n_alive and state bit for bit, and a
    graph per key."""
    from test_torch_trainer_port import configs, make_scene
    from rain_tpu_torch.train.trainer import Trainer
    import torch_trainer_trace as trace_mod
    scene = make_scene(n_pts=400, size=64)
    runs = []
    for eager in (False, True):
        with monkeypatch.context() as mp:
            if eager:
                mp.setattr(compiled.CompiledStep, "train_step",
                           lambda self, *a, **kw: step.train_step(*a, **kw))
                mp.setattr(compiled.CompiledStep, "eval_render",
                           lambda self, *a, **kw: step.eval_render(*a, **kw))
                mp.setattr(compiled.CompiledStep, "densify_and_prune",
                           lambda self, *a, **kw:
                           densify_mod.densify_and_prune(*a, **kw))
                mp.setattr(compiled.CompiledStep, "reset_opacity",
                           lambda self, s, o, **kw:
                           densify_mod.reset_opacity(s, o))
            trace = trace_mod.record(mp.setattr, compiled.CompiledStep,
                                     compiled.CompiledStep, gmod)
            cfgs = configs(dict(iterations=12, densify_from_iter=4,
                                densification_interval=6,
                                opacity_reset_interval=10_000),
                           dict(capacity=640, max_instances=512))
            tr = Trainer(scene, cfgs, str(tmp_path / str(eager)),
                         device=cuda, log_fn=lambda *a: None,
                         tensorboard=False)
            tr.train(iterations=12, test_iterations=(12,),
                     save_iterations=())
            runs.append((tr, trace_mod.steps(trace),
                         trace_mod.events(trace, scene)))
    (a, sa, ca), (b, sb, cb) = runs
    assert sa == sb and ca == cb
    assert any(c[0] == "grow" for c in ca) and a.max_instances > 512
    assert sum(c[0] == "densify" for c in ca) == 2
    assert a._steps.densify_keys and not b._steps.densify_keys
    assert a.state.n_alive == b.state.n_alive
    for x, y in zip(list(a.state.params) + list(a.opt_state.mu) +
                    list(a.opt_state.nu),
                    list(b.state.params) + list(b.opt_state.mu) +
                    list(b.opt_state.nu)):
        assert torch.equal(x, y)
    assert a.history == b.history
    assert len(a._steps.captures) >= 3 and not b._steps.captures


def test_trainer_started_in_memory_compiled_equals_eager_on_card(
        cuda, tmp_path, monkeypatch):
    """Two episodes of ``Trainer.train(start=...)`` from one state in
    memory (the --ours_new preset: abe_split rounds, the size threshold
    past the reset), through the compiled step, round and reset (the
    first episode captures each key, the second replays them), against
    one episode with CompiledStep's methods replaced by the eager ones:
    the same counters, n_alive and state bit for bit, two rounds and one
    reset an episode, a graph per key."""
    import dataclasses
    from test_torch_trainer_port import make_scene
    from rain_tpu_torch import config as cfg_mod
    from rain_tpu_torch.train.trainer import Trainer
    scene = make_scene(n_pts=400, size=64)

    def episode(tr, s0):
        before = tr.counters()
        tr.train(18, start=(s0, adam_mod.init(s0.params), 6, 0.3))
        tensors = (list(tr.state.params) + list(tr.opt_state.mu) +
                   list(tr.opt_state.nu) +
                   [getattr(tr.state, k) for k in gmod.STAT_FIELDS])
        return ({k: v - before[k] for k, v in tr.counters().items()},
                tr.state.n_alive, [x.clone() for x in tensors])

    runs = []
    for eager in (False, True):
        with monkeypatch.context() as mp:
            if eager:
                mp.setattr(compiled.CompiledStep, "train_step",
                           lambda self, *a, **kw: step.train_step(*a, **kw))
                mp.setattr(compiled.CompiledStep, "densify_and_prune",
                           lambda self, *a, **kw:
                           densify_mod.densify_and_prune(*a, **kw))
                mp.setattr(compiled.CompiledStep, "reset_opacity",
                           lambda self, s, o, **kw:
                           densify_mod.reset_opacity(s, o))
            cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args(
                ["--ours_new"]))
            cfgs["opt"] = dataclasses.replace(
                cfgs["opt"], densify_from_iter=4, densification_interval=6,
                opacity_reset_interval=12)
            cfgs["system"] = dataclasses.replace(
                cfgs["system"], capacity=4096, max_instances=65536)
            tr = Trainer(scene, cfg_mod.apply_method_presets(cfgs),
                         str(tmp_path / str(eager)), device=cuda,
                         log_fn=lambda *a: None, tensorboard=False)
            s0 = tr.state
            runs.append([episode(tr, s0) for _ in range(1 if eager else 2)])
            keys = (tr._steps.densify_keys, tr._steps.reset_keys,
                    len(tr._steps.captures))
            if not eager:
                captured = keys
    (first, second), (want,) = runs
    for got in (first, second):
        assert got[0] == want[0] and got[1] == want[1]
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got[2], want[2]))
    assert want[0]["rounds"] == 2 and want[0]["resets"] == 1
    assert want[0]["refires"] == 0
    densify_keys, reset_keys, n_captures = captured
    assert {k.use_size_threshold for k in densify_keys} == {False, True}
    assert all(k.abe_split for k in densify_keys) and len(reset_keys) == 1
    assert n_captures == 4 and keys[2] == 0


def test_captured_sharded_step_replays_equal_eager_over_nccl(cuda):
    """Two ranks, one card each, over NCCL (launch.spawn's default for
    cards): the sharded step through CompiledStep is captured once per rank
    and its 5 replays each equal the eager NCCL step bit for bit on every
    rank, with B1-B4, the SSIM map's two and Adam counted once per replay
    (preprocess's kernels never: the sharded step takes the plain ops). Skips with fewer than two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one per NCCL rank")
    import torch_sharding_cases as cases
    from rain_tpu_torch.parallel import launch
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (80, 2)),
                          rng.uniform(2.5, 5.0, (80, 1))], 1).astype(
        np.float32)
    st = gmod.create_from_pcd(pts, rng.uniform(0, 1, (80, 3)).astype(
        np.float32), sh_degree=3, capacity=128, knn_window=16, device="cpu")
    start = ({k: v.numpy() for k, v in st.params._asdict().items()},
             st.n_alive)
    ranks = launch.spawn(cases.captured_sharded_step, 2, device="cuda",
                         timeout_s=300, args=(*start, 4096, 5))
    for r in ranks:
        assert r["equal"] == [True] * 5, r
        assert (r["graphs"], r["captures"]) == (1, 1)
        # the sharded step preprocesses with plain ops (colors_override)
        assert r["launches"] == [[1, 1, 1, 1, 0, 0, 1, 1, 0, 1]] * 5
