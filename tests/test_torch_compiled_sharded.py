"""The sharded Trainer's compiled steps (train.compiled.CompiledStep's
sharded_train_step) on the CPU, two gloo ranks (parallel.launch.spawn).

Its keys are rain_tpu's: each call the port's ranks make gives the key
that rain_tpu's ``Trainer._get_sharded_step`` (rain_tpu/train/
trainer.py:272-283) makes of the same width, height, SH degree, tier,
devices and update_densify_stats, with lambda_dssim, the rank and the
shard's capacity added. On gloo nothing is captured: the step runs eagerly
(its bits against make_sharded_train_step's are
tests/test_torch_sharding.py::test_sharded_step_takes_device_values), and
rank 0's report renders go through the same CompiledStep's eval_render at
the whole capacity. rain_tpu's key is taken from its Trainer's method
with the step's maker stubbed: no JAX compilation. And the order of
the values a graph takes and gives, on the CPU.
"""

from types import SimpleNamespace

import numpy as np
import torch

from rain_tpu.parallel import sharding as jsharding
from rain_tpu.train import trainer as jtrainer
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.parallel import launch
from rain_tpu_torch.train import compiled, step
import torch_sharding_cases as cases

torch.set_num_threads(1)

TIMEOUT_S = 300
DEVICES = 2


def _rain_tpu_keys(calls, lambda_dssim, monkeypatch) -> set:
    """The keys rain_tpu's sharded Trainer makes for ``calls`` (width,
    height, sh_degree, tier, update_densify_stats) at DEVICES devices."""
    monkeypatch.setattr(jsharding, "make_mesh", lambda n: n)
    monkeypatch.setattr(jsharding, "make_sharded_train_step",
                        lambda mesh, **kw: kw)
    tr = SimpleNamespace(n_devices=DEVICES, _sharded_steps={},
                         opt_cfg=SimpleNamespace(lambda_dssim=lambda_dssim))
    for width, height, sh_degree, tier, update in calls:
        tr.max_instances = tier
        made = jtrainer.Trainer._get_sharded_step(tr, width, height,
                                                  sh_degree, update)
        assert made["max_instances_per_shard"] == tier
        assert made["lambda_dssim"] == lambda_dssim
    return set(tr._sharded_steps)


def test_sharded_trainer_keys_are_rain_tpus(tmp_path, monkeypatch):
    ranks = launch.spawn(cases.sharded_trainer_keys, DEVICES, device="cpu",
                         timeout_s=TIMEOUT_S, args=(str(tmp_path),))
    for rank, r in enumerate(ranks):
        # the statistics stop at iteration 8: two keys
        assert [c[-1] for c in r["calls"]] == [False, True], r["calls"]
        want = {(w, h, sh, tier, r["lambda_dssim"], update, devices, rank,
                 r["shard_capacity"])
                for w, h, sh, tier, devices, update in _rain_tpu_keys(
                    r["calls"], r["lambda_dssim"], monkeypatch)}
        assert set(r["keys"]) == want
        assert (r["graphs"], r["captures"]) == (0, 0)
    # only rank 0 renders the report, at the whole capacity
    whole = ranks[0]["shard_capacity"] * DEVICES
    assert ranks[0]["eval_keys"] and all(
        k[-1] == whole for k in ranks[0]["eval_keys"])
    assert ranks[1]["eval_keys"] == []


def test_graph_buffers_round_trip():
    """The inputs a graph of CompiledStep takes and the outputs it gives:
    a training step's values flattened into buffers
    (``compiled._step_inputs``) and read back (``_step_args``) give the
    step of the values themselves, and its results flattened
    (``_step_outputs``) and read back (``_step_results``) are the same
    tensors, bucketed and not. On the card these lists are the graphs'
    static inputs and outputs, so this is the CPU's check of their order."""
    rng = np.random.default_rng(0)
    n, w, h = 300, 48, 32
    state = gmod.from_arrays(
        np.concatenate([rng.uniform(-1, 1, (n, 2)),
                        rng.uniform(2, 5, (n, 1))], 1),
        rng.normal(0, 0.5, (n, 1, 3)), rng.normal(0, 0.1, (n, 15, 3)),
        rng.uniform(-4, -3, (n, 3)), rng.normal(size=(n, 4)),
        rng.normal(0, 1.5, (n, 1)), device="cpu")
    state = state._replace(n_alive=torch.tensor(n - 7, dtype=torch.int32))
    opt = adam_mod.init(state.params)
    cam = Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.9, fovy=0.7, image=None, width=w,
                 height=h).render_inputs("cpu")
    gt = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    bg = torch.tensor([0.1, 0.2, 0.3])
    leaves = {k: torch.tensor(v) for k, v in cases.OPT_LEAVES.items()}
    for wh in ((), (torch.tensor(w - 5, dtype=torch.int32),
                    torch.tensor(h - 3, dtype=torch.int32))):
        values = (state, opt, cam, gt, bg, torch.tensor(0.3),
                  torch.tensor(1e-3), leaves)
        xs, dtypes = compiled._step_inputs(*values, wh)
        assert len(xs) == len(dtypes)
        st, op, c, g, b, lp, lr, lv, rwh = compiled._step_args(xs, len(wh))
        kw = dict(width=w, height=h, sh_degree=3, max_instances=1 << 14)
        want = step.train_step(*values[:7], opt_cfg_leaves=leaves,
                               real_wh=wh or None, **kw)
        got = step.train_step(st, op, c, g, b, lp, lr, opt_cfg_leaves=lv,
                              real_wh=rwh or None, **kw)
        flat = compiled._step_outputs(*got)
        s2, o2, aux = compiled._step_results(flat, state.n_alive)
        assert s2.n_alive is state.n_alive
        back = compiled._step_outputs(
            s2, o2, want[2]._replace(loss=aux[0], l1=aux[1],
                                     num_instances=aux[2],
                                     instance_overflow=aux[3]))
        assert all(x is y for x, y in zip(back, flat))
        for x, y in zip(flat, compiled._step_outputs(*want)):
            assert torch.equal(x, y)
