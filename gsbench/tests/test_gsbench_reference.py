"""The plain reference against the program (rain_tpu_torch's CPU path,
whose kernels run their plain versions) at a tiny size, and against the
program's sequential compositing oracle. The test imports the program;
the reference does not."""

import torch

from gsbench import camera, scene
from gsbench.reference import composite as comp
from gsbench.reference import preprocess
from gsbench.reference import step as ref
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import projection, reference_composite
from rain_tpu_torch.train import step as pstep

W, H = 64, 48
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}
HP = {"low_pass": 0.3, "xyz_lr": 1.6e-4, "opt_leaves": OPT,
      "lambda_dssim": 0.2}
CFG = {"n_gaussians": 400, "capacity": 400, "sh_degree": 3,
       "box": {"xy": [-3.0, 3.0], "z": [2.0, 12.0]}, "f_rest_sigma": 0.1,
       "log_scale": -2.5, "opacity_logit": -1.0}


def _scene(seed=3):
    p = scene.make_params(CFG, seed, "cpu")
    cams = camera.stack([camera.pan_pose(k) for k in range(5)], "cpu")
    return p, cams, scene.make_targets(5, H, W, seed, "cpu")


def test_three_training_steps_match_the_program():
    p, cams, gt = _scene()
    st = gmod.GaussianState(gmod.GaussianParams(**p), 400,
                            *[torch.zeros(400) for _ in range(3)])
    op = adam_mod.init(st.params)
    rp, rs, ro = dict(p), ref.stats_init(400, torch.float32, "cpu"), \
        ref.adam_init(p)
    bg = torch.zeros(3)
    for k in (0, 3, 1):
        st, op, aux = pstep.train_step(
            st, op, camera.pick(cams, k), gt[k], bg, 0.3, 1.6e-4, width=W,
            height=H, sh_degree=3, max_instances=20000, opt_cfg_leaves=OPT)
        out = ref.train_step(rp, rs, ro, camera.pick(cams, k), gt[k], bg,
                             HP, width=W, height=H, sh_degree=3)
        rp, rs, ro = out.params, out.stats, out.opt
        assert out.instances == int(aux.num_instances)
        assert abs(out.loss - float(aux.loss)) <= 1e-6 * out.loss
        for name in ref.LEAVES:
            torch.testing.assert_close(getattr(st.params, name), rp[name],
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(getattr(op.mu, name), ro["mu"][name],
                                       rtol=1e-4, atol=1e-9)
        for name in ref.STATS:
            torch.testing.assert_close(getattr(st, name), rs[name],
                                       rtol=1e-5, atol=1e-7)


def test_frame_matches_the_program_and_the_sequential_oracle():
    p, cams, _ = _scene(5)
    st = gmod.GaussianState(gmod.GaussianParams(**p), 400,
                            *[torch.zeros(400) for _ in range(3)])
    bg = torch.tensor([0.1, 0.2, 0.3])
    cam = camera.pick(cams, 2)
    out = pstep.eval_render(st, cam, bg, 0.3, width=W, height=H,
                            sh_degree=3, max_instances=20000)
    fr = ref.render(p, cam, bg, width=W, height=H, sh_degree=3,
                    low_pass=0.3)
    assert fr.instances == int(out.num_instances)
    torch.testing.assert_close(fr.image, out.render, rtol=0, atol=1e-6)
    torch.testing.assert_close(fr.final_t, out.final_t, rtol=0, atol=1e-6)
    scales, quats, opac, shs = gmod.activate(st.params)
    prep = projection.preprocess(
        p["xyz"], scales, quats, opac, shs, gmod.alive_mask(st), sh_degree=3,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        camera_center=cam["camera_center"], tan_fovx=cam["tanfovx"],
        tan_fovy=cam["tanfovy"], width=W, height=H, low_pass=0.3)
    oracle = reference_composite.composite_reference(prep, W, H, bg)
    torch.testing.assert_close(fr.image, oracle["render"], rtol=0,
                               atol=1e-6)


def test_blocks_cover_every_instance_once():
    p, cams, _ = _scene(7)
    s = preprocess.screen(p, camera.pick(cams, 1), width=W, height=H,
                          sh_degree=3, low_pass=0.3)
    inst = comp.instances(s, 4, 3)
    seen = torch.zeros(12, dtype=torch.int64)
    for tiles, k in comp.blocks(inst, budget=3 * 256 * 40):
        assert int(inst.count[tiles].max()) == k
        seen[tiles] += 1
    assert torch.equal(seen, (inst.count > 0).to(torch.int64))
    assert int(inst.count.sum()) == inst.total == int(s.tiles.sum())
