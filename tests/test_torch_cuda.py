"""Kernels against their plain versions on a CUDA card (skipped without).

Run on a machine with a card: ``python -m pytest tests/test_torch_cuda.py``.
chip_smoke.py makes the same checks at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.train import step
from torch_expand_cases import CASES, expand_case

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
