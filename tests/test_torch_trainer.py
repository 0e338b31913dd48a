"""Port parity for the Trainer loop: rain_tpu_torch's Trainer against
rain_tpu's on the toy scene of tests/test_training.py:17-53.

The ground truth and the init points are made once, with JAX, and given to
both trainers as numpy. Each test wraps, with ``monkeypatch``, the names
each trainer module calls (``train_step``, ``densify_and_prune``,
``reset_opacity``, ``grow_capacity``); the wrappers of
tests/torch_trainer_trace.py (which chip_smoke.py shares) record each
call's arguments and results and call through. Nothing in rain_tpu
changes.

- The port draws its split noise from a torch.Generator, which cannot
  reproduce jax.random, so its ``Trainer._split_noise`` is replaced by a
  replay of the JAX trainer's key sequence: ``key = jax.random.key(seed)``,
  then one split per round.
- ``create_from_pcd`` is not bitwise on this scene: XLA's CPU log is not
  correctly rounded (about one value in ten sits an ulp from torch's), so
  the scales differ by an ulp. The port trainer's ``create_from_pcd`` is
  replaced by a carry of JAX's initial state (``from_numpy``).

The schedule traces must be identical: camera uid, xyz lr and low-pass
(as f32), SH degree, ``update_densify_stats``, ``max_instances``,
capacity and n_alive of every ``train_step`` call (so the overflow
retries too), each
round's arguments and DensifyInfo, the resets and the growths. Losses
agree to rtol 1e-4 up to the first densify round (the one-step bar of
tests/test_torch_train_step.py is 1e-5; a few steps compound it). After
it the split children sit at offsets drawn from the same noise but scaled
by exp() of the scales, where XLA's and torch's exp differ by an ulp; the
largest relative difference measured there was 1.5e-5 over 20 steps, and
the losses are held to LATE_RTOL = 1e-4.
The final n_alive must be equal. On the JAX side every densify round
asserts that no live Gaussian's gradient norm lies within GRAD_MARGIN
(relative) of the threshold, and no opacity within it of min_opacity, so
a flipped selection fails with its cause named.

JAX compiles train_step once per (capacity, tier): here the first tier
overflows and the retry runs at the grown one, two compilations in all,
and the capacity grows at the last iteration, so no step runs at it
(tests/test_torch_trainer_growth.py trains on across a growth).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from rain_tpu import config as jcfg
from rain_tpu.model import densify as jdensify
from rain_tpu.model import gaussians as jgmod
from rain_tpu.train import step as jstep
from rain_tpu.train import trainer as jtrainer
from rain_tpu_torch import config as tcfg
from rain_tpu_torch.data.cameras import Camera as TCamera
from rain_tpu_torch.data.dataset import SceneData as TScene
from rain_tpu_torch.model import densify as tdensify
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.train import step as tstep
from rain_tpu_torch.train import trainer as ttrainer
from test_training import _make_scene
import torch_trainer_trace as trainer_trace

torch.set_num_threads(1)

EARLY_RTOL = 1e-4
LATE_RTOL = 1e-4
GRAD_MARGIN = 1e-3
SEED = 0


def port_scene(jscene) -> TScene:
    """The same scene with the port's cameras (numpy fields copied)."""
    def cam(c):
        return TCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T,
                       fovx=c.fovx, fovy=c.fovy, image=c.image,
                       width=c.width, height=c.height)
    return TScene(train_cameras=[cam(c) for c in jscene.train_cameras],
                  test_cameras=[cam(c) for c in jscene.test_cameras],
                  points=jscene.points, colors=jscene.colors,
                  nerf_radius=jscene.nerf_radius,
                  nerf_translate=jscene.nerf_translate)


@pytest.fixture(scope="module")
def scenes():
    """The toy scene, its init colours lifted off the exact 0 that
    np.clip leaves there: such a channel's colour C0·sh + 0.5 is 0 in
    torch but a hair below it in XLA's fused multiply-add, so the clamp
    passes its gradient in one package and not in the other, and Adam's
    first step then moves that coefficient by a full lr."""
    jscene = _make_scene()
    jscene = dataclasses.replace(jscene,
                                 colors=np.maximum(jscene.colors, 1e-3))
    return jscene, port_scene(jscene)


def configs(cfg_mod, opt, system, rain=None, model=None):
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(cfgs["opt"], **opt)
    cfgs["system"] = dataclasses.replace(cfgs["system"], **system)
    cfgs["rain"] = dataclasses.replace(cfgs["rain"], **(rain or {}))
    cfgs["model"] = dataclasses.replace(cfgs["model"], **(model or {}))
    return cfgs


def _margins(state, kw):
    """Assert the densify selections of a JAX state are robust: no live
    gradient norm within GRAD_MARGIN of the threshold, no opacity within
    it of min_opacity and no max scale within it of percent_dense·extent
    (XLA's exp and torch's differ by an ulp)."""
    n = int(state.n_alive)
    accum = np.asarray(state.xyz_gradient_accum)[:n]
    denom = np.asarray(state.denom)[:n]
    seen = denom > 0
    grads = accum[seen] / denom[seen]
    for what, vals, thr in (
            ("a gradient norm", grads, kw["max_grad"]),
            ("an opacity", 1 / (1 + np.exp(-np.asarray(
                state.params.opacity, np.float64)[:n])), kw["min_opacity"]),
            ("a max scale", np.exp(np.asarray(
                state.params.scaling, np.float64)[:n]).max(axis=1),
             kw["percent_dense"] * kw["extent"])):
        rel = np.abs(vals - thr) / thr
        assert rel.min(initial=1.0) > GRAD_MARGIN, (
            f"{what} lies within {rel.min():.2e} (relative) of its densify "
            f"threshold: pick another seed")


def record(monkeypatch, side):
    """Wrap the names the trainer of ``side`` ("jax" or "torch") calls
    (tests/torch_trainer_trace.py); on the JAX side each round first
    checks its selections' margins. Returns the trace."""
    mods = ((jstep, jdensify, jgmod) if side == "jax" else
            (tstep, tdensify, tgmod))
    return trainer_trace.record(
        monkeypatch.setattr, *mods,
        before_densify=_margins if side == "jax" else None)


def replay_jax_noise(monkeypatch, seed):
    """The port's split noise replaced by the JAX trainer's draws: its key
    from jax.random.key(seed), split once per round."""
    keys = {"key": jax.random.key(seed)}

    def split_noise(self, capacity):
        keys["key"], sub = jax.random.split(keys["key"])
        return torch.from_numpy(np.array(
            jax.random.normal(sub, (2, capacity, 3))))

    monkeypatch.setattr(ttrainer.Trainer, "_split_noise", split_noise)


def carry_jax_init(monkeypatch):
    """The port trainer's create_from_pcd replaced by a carry of rain_tpu's
    initial state."""
    def create_from_pcd(points, colors, *, sh_degree, capacity,
                        knn_window=0, device=None):
        js = jgmod.create_from_pcd(points, colors, sh_degree=sh_degree,
                                   capacity=capacity, knn_window=knn_window)
        return tgmod.from_numpy(
            {k: np.asarray(v) for k, v in js.params._asdict().items()},
            int(js.n_alive), device=device)

    monkeypatch.setattr(tgmod, "create_from_pcd", create_from_pcd)


def run_pair(monkeypatch, scenes, tmp_path, opt, system, rain=None,
             model=None, iterations=None):
    """Train both packages' Trainers on the toy scene under the same
    configuration; returns ((trainer, trace) for JAX, for the port), each
    trace {"events": trainer_trace.events, "steps": trainer_trace.steps}."""
    jscene, tscene = scenes
    out = []
    for side in ("jax", "torch"):
        with monkeypatch.context() as m:
            trace = record(m, side)
            if side == "jax":
                tr = jtrainer.Trainer(
                    jscene, configs(jcfg, opt, system, rain, model),
                    str(tmp_path / side), log_fn=lambda *a: None,
                    tensorboard=False)
            else:
                replay_jax_noise(m, system.get("seed", 0))
                carry_jax_init(m)
                tr = ttrainer.Trainer(
                    tscene, configs(tcfg, opt, system, rain, model),
                    str(tmp_path / side), device="cpu",
                    log_fn=lambda *a: None, tensorboard=False)
            tr.train(iterations=iterations, test_iterations=(),
                     save_iterations=())
        scene = jscene if side == "jax" else tscene
        out.append((tr, {"events": trainer_trace.events(trace, scene),
                         "steps": trainer_trace.steps(trace)}))
    return out


def check_traces(jax_run, torch_run):
    """The schedule traces equal; losses at the stated bars. Returns the
    largest relative loss difference after the first densify round."""
    (jt, jtrace), (tt, ttrace) = jax_run, torch_run
    assert ttrace["events"] == jtrace["events"]
    first = next((i for i, e in enumerate(jtrace["events"])
                  if e[0] == "densify"), len(jtrace["events"]))
    n_early = sum(1 for e in jtrace["events"][:first] if e[0] == "step")
    jl = np.array([s[0] for s in jtrace["steps"]])
    tl = np.array([s[0] for s in ttrace["steps"]])
    np.testing.assert_allclose(tl[:n_early], jl[:n_early], rtol=EARLY_RTOL)
    late = np.abs(tl[n_early:] - jl[n_early:]) / np.abs(jl[n_early:])
    assert late.max(initial=0.0) < LATE_RTOL, late
    assert [s[1:] for s in ttrace["steps"][:n_early]] == \
        [s[1:] for s in jtrace["steps"][:n_early]]
    assert tt.state.n_alive == int(jt.state.n_alive)
    assert tt.max_instances == jt.max_instances
    assert tt.state.capacity == jt.state.capacity
    return float(late.max(initial=0.0))


def test_trainer_trace_matches_rain_tpu(monkeypatch, scenes, tmp_path):
    """Iteration 1 overflows max_instances 256 and is run again at the
    grown tier; opacity resets at 5 and 10; one densify round at the last
    iteration, after the capacity grew (120 > 0.6·192), with clones,
    splits, the abe_split warmup pass and the size threshold."""
    jax_run, torch_run = run_pair(
        monkeypatch, scenes, tmp_path,
        opt=dict(iterations=10, densify_from_iter=5,
                 densification_interval=10, densify_until_iter=40,
                 opacity_reset_interval=5, percent_dense=0.05),
        system=dict(capacity=192, max_instances=256, seed=SEED,
                    log_every=5),
        rain=dict(warmup_iter=12))
    events = jax_run[1]["events"]
    kinds = [e[0] for e in events]
    assert kinds.count("reset") == 2
    assert [e for e in events if e[0] == "grow"] == [("grow", 192, 4096)]
    # the first steps overflowed and were run again at the grown tier
    steps = [e for e in events if e[0] == "step"]
    flags = [s[1] for s in jax_run[1]["steps"]]
    assert flags[0] and not any(flags[2:])
    assert {s[6] for s in steps} == {256, 512}
    (dens,) = [e for e in events if e[0] == "densify"]
    assert dens[3] and dens[4]                      # abe, size threshold
    assert dens[1] == 4096 and dens[5][0] > 0 and dens[5][1] > 0
    late = check_traces(jax_run, torch_run)
    assert late == 0.0                  # no step after the round


def test_instance_tier_ladder_matches_rain_tpu():
    """tests/test_model.py:169-189's ladder and overflow jump."""
    for m in (1, 2, 3, 5, 512, 65536, 262144, 393216, 1245184, 3720126,
              (1 << 26) + 1):
        assert ttrainer._next_instance_tier(m) == \
            jtrainer._next_instance_tier(m)
    m, seq = 262144, [262144]
    for _ in range(6):
        m = ttrainer._next_instance_tier(m)
        seq.append(m)
    assert seq == [262144, 393216, 524288, 786432, 1048576, 1572864,
                   2097152]
    m = 1245184
    while m < 3720126:
        m = ttrainer._next_instance_tier(m)
    assert m == 4194304
    for x, mult in ((1, 16), (4095, 4096), (4096, 4096), (4097, 4096)):
        assert ttrainer._round_up(x, mult) == jtrainer._round_up(x, mult)
