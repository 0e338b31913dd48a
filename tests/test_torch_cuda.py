"""Kernels against their plain versions on a CUDA card (skipped without).

Run on a machine with a card: ``python -m pytest tests/test_torch_cuda.py``.
chip_smoke.py makes the same checks at the main path's full shapes.
"""

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
from rain_tpu_torch.scripts import knn_deviation, probe_scale
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step
from torch_expand_cases import CASES, expand_case
from torch_reduce_cases import CASES as REDUCE_CASES
from torch_step_kernels import compare_backward, compare_forward
from torch_reduce_cases import reduce_case

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


def _ab_grads(state, device, **paths):
    from rain_tpu_torch.ops import render as render_ops
    xs = [x.detach().clone().requires_grad_(True) for x in state.params]
    scales, quats, opac, shs = gmod.activate(gmod.GaussianParams(*xs))
    out = render_ops.render(
        xs[0], scales, quats, opac, shs, gmod.alive_mask(state),
        camera=_camera(device), width=W, height=H, sh_degree=3,
        bg=torch.zeros(3, device=device), low_pass=0.3, max_instances=M,
        **paths)
    out.render.square().sum().backward()
    return out, [x.grad for x in xs]


def test_ab_paths_on_card_match_main_path_and_cpu(cuda):
    """The legacy expansion and the scatter reduction on the card: one
    image with the fused path, one set of gradients with each other, the
    same bits on a second run, and the CPU's values."""
    state = _state(cuda)
    legacy, g_legacy = _ab_grads(state, cuda, expand="legacy")
    fused, g_scatter = _ab_grads(state, cuda, reduce="scatter")
    _, g_kernel = _ab_grads(state, cuda)
    assert torch.equal(legacy.render, fused.render)
    assert torch.equal(legacy.n_contrib, fused.n_contrib)
    for a, b, c, d in zip(g_legacy, g_scatter, g_kernel,
                          _ab_grads(state, cuda, expand="legacy")[1]):
        assert torch.equal(a, b) and torch.equal(a, d)
        assert (a - c).abs().max() <= 1e-4 * c.abs().max()
    _, g_cpu = _ab_grads(_state("cpu"), torch.device("cpu"),
                         expand="legacy")
    for a, b in zip(g_legacy, g_cpu):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()


def test_bin_gaussians_sorts_agree_on_card(cuda):
    from rain_tpu_torch.ops import binning as binning_ops
    seen = {}
    step.eval_render(_state(cuda), _camera(cuda), torch.zeros(3, device=cuda),
                     0.3, width=W, height=H, sh_degree=3, max_instances=M,
                     on_stage=seen.__setitem__)
    a, b = (binning_ops.bin_gaussians(seen["preprocess"], GX, GY, M, sort=s)
            for s in binning_ops.SORTS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


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
    return [f.launches for f in compiled.COUNTED]


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
    bit for bit; the inputs are left untouched; B1-B4's counters count
    one launch per call, replays included."""
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
        assert [b - a for a, b in zip(n0, _launches())] == [1, 1, 1, 1]
        for a, b in zip(_tensors(got), _tensors(want)):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(before, given))
        assert got[0].n_alive is x["n_alive"]
        state, opt = got[0], got[1]
    # update_densify_stats False at step 3 is its own key
    assert len(steps.captures) == 2 and len(steps.graphs) == 2
    assert float(got[2].loss) > 0.0 and not bool(got[2].instance_overflow)


def test_compiled_eval_render_replays_equal_eager(cuda):
    """Five frames through one graph: another camera, n_alive, low_pass,
    background and scale_modifier each time; each equals the eager
    eval_render bit for bit, and B1 and B3 count one launch per frame."""
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
        assert [b - a for a, b in zip(n0, _launches())] == [1, 0, 1, 0]
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
    CompiledStep's methods replaced by the eager step, across an overflow
    retry, a capacity growth and densify rounds: the same losses, n_alive
    and state bit for bit, and a graph per key."""
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
            trace = trace_mod.record(mp.setattr, compiled.CompiledStep,
                                     densify_mod, gmod)
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
    assert a.state.n_alive == b.state.n_alive
    for x, y in zip(list(a.state.params) + list(a.opt_state.mu) +
                    list(a.opt_state.nu),
                    list(b.state.params) + list(b.opt_state.mu) +
                    list(b.opt_state.nu)):
        assert torch.equal(x, y)
    assert a.history == b.history
    assert len(a._steps.captures) >= 3 and not b._steps.captures
