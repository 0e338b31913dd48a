"""The Trainer's benchmark cell on the CPU, at tiny sizes (no JAX).

- The port's densify round (``model/densify.py``) against the plain
  reference of ``gsbench/reference/densify.py``, with the abe_split
  pre-pass on and off and the size threshold on and off: n_alive, the
  counts and the rows' order exact, the leaves within RTOL / ATOL (the
  reference's split scale is log(exp(s) / (r·N)) where the port takes
  s − log(r·N), its abe position (x·0.3)·extent where the port takes
  x·(0.3·extent), its children's offsets a batched product: each an ulp
  or two apart), the moments bit for bit (rows moved, never computed).
- The opacity reset against the reference's, bit for bit.
- ``Trainer.train(start=...)``: two episodes from one state in memory end
  in the same state and counters bit for bit; the counters of a short
  episode (one round, one reset, one flags read an iteration); the
  ``rain.trainer.*`` spans in a profiled episode, a rollback's included.
- ``gsbench.run.run_cell`` on a copy of ``init262k.trainer`` cut to
  48×32 px, 80 Gaussians and the slice 20–40 with a round every 10
  iterations and the reset at 30 (in a process of its own: the harness
  refuses to run where jax is loaded): a sound run is correct, each
  planted fault of ``gsbench/loops/trainer.py:FAULTS`` is not, and a
  traced run reads the cell's per-layer metrics.
- The round reader reads a round's marks from a trace.
- The cell's inputs: its dead-leaves targets (the same for a seed,
  painted in blocks as disc by disc), its extent (``nerfpp_norm`` of the
  ring in the program, ``scene_extent`` of the ring in the reference)
  and its start held to ``scene.make_params``'s plain construction.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_round_cases as rounds
from gsbench import trace as trace_mod
from gsbench import trainer_trace
from gsbench.loops import trainer as trainer_loop
from gsbench.reference import densify as ref_densify
from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import adam
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.train.trainer import COUNTERS, Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "init262k.trainer"
SEED = 2**31 + 23
RTOL, ATOL = 1e-6, 1e-6
CAP, N0 = 700, 200


def _seeded_state(seed):
    rng = np.random.default_rng(seed)
    n = N0
    xyz = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(2, 8, (n, 1))], 1)
    state = gmod.from_arrays(
        xyz, rng.normal(0, 0.5, (n, 1, 3)), rng.normal(0, 0.1, (n, 15, 3)),
        np.log(rng.uniform(0.004, 0.05, (n, 3))), rng.normal(size=(n, 4)),
        rng.normal(0, 1.5, (n, 1)), capacity=CAP, device="cpu")
    return rounds.seeded(state, n, seed=seed)


@pytest.mark.parametrize("abe_split", [True, False])
@pytest.mark.parametrize("use_size_threshold", [False, True])
def test_round_matches_the_reference(abe_split, use_size_threshold):
    st, opt = _seeded_state(3)
    noise = rounds.noise(CAP, "cpu", seed=13)
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=1.1,
              percent_dense=0.01, divide_ratio=0.7)
    new, new_opt, info = densify_mod.densify_and_prune(
        st, opt, noise, size_threshold=20.0,
        use_size_threshold=use_size_threshold, abe_split=abe_split, **kw)
    n0 = st.n_alive
    params, mu, nu, stats, counts = ref_densify.densify_and_prune(
        {k: v[:n0] for k, v in st.params._asdict().items()},
        {k: getattr(st, k)[:n0] for k in gmod.STAT_FIELDS},
        {k: v[:n0] for k, v in opt.mu._asdict().items()},
        {k: v[:n0] for k, v in opt.nu._asdict().items()},
        noise[:, :n0], max_screen_size=20.0 if use_size_threshold else None,
        abe_split=abe_split, **kw)
    n = info.n_alive
    assert not info.overflow and info.n_cloned > 0 and info.n_split > 0
    assert (n, info.n_cloned, info.n_split, info.n_pruned) == (
        counts["n_alive"], counts["clones"], counts["splits"],
        counts["pruned"])
    abe = n + info.n_pruned - n0 - info.n_cloned - 2 * info.n_split
    assert abe == counts["abe"] == (info.n_split if abe_split else 0)
    for k, v in new.params._asdict().items():
        torch.testing.assert_close(v[:n], params[k], rtol=RTOL, atol=ATOL)
    for k in mu:
        assert torch.equal(getattr(new_opt.mu, k)[:n], mu[k])
        assert torch.equal(getattr(new_opt.nu, k)[:n], nu[k])
    for k in gmod.STAT_FIELDS:
        assert torch.equal(getattr(new, k)[:n], stats[k])


def test_reset_matches_the_reference():
    st, opt = _seeded_state(4)
    new, new_opt = densify_mod.reset_opacity(st, opt)
    n = st.n_alive
    want = ref_densify.reset_opacity(st.params.opacity[:n])
    assert torch.equal(new.params.opacity[:n], want)
    assert not new_opt.mu.opacity.any() and not new_opt.nu.opacity.any()


# --- the Trainer started in memory ---------------------------------------
def _scene(n=60, size=32, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)),
                          rng.uniform(3.0, 4.5, (n, 1))], 1).astype(np.float32)
    cams = []
    for i in range(3):
        ang = (i - 1) * 0.06
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(Camera(uid=i, image_name=f"c{i}", R=R, T=np.zeros(3),
                           fovx=0.9, fovy=0.9, width=size, height=size,
                           image=rng.uniform(0, 1, (3, size, size)).astype(
                               np.float32)))
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                     nerf_radius=0.5, nerf_translate=np.zeros(3))


def _trainer(tmp_path, max_instances=16384, interval=10):
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args(
        ["--ours_new"]))
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], densify_from_iter=5, densification_interval=interval,
        opacity_reset_interval=20)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], capacity=1024, max_instances=max_instances)
    cfgs = cfg_mod.apply_method_presets(cfgs)
    return Trainer(_scene(), cfgs, str(tmp_path), device="cpu",
                   log_fn=lambda *a: None, tensorboard=False)


def _episode(tr, s0, first, last):
    before = tr.counters()
    tr.train(last, start=(s0, adam.init(s0.params), first, 0.3))
    return {k: v - before[k] for k, v in tr.counters().items()}


def _tensors(tr):
    return (list(tr.state.params) + list(tr.opt_state.mu) +
            list(tr.opt_state.nu) +
            [getattr(tr.state, k) for k in gmod.STAT_FIELDS])


def test_two_episodes_from_one_start_are_the_same(tmp_path):
    tr = _trainer(tmp_path)
    s0 = tr.state
    kept = [x.clone() for x in s0.params]
    runs = []
    for _ in range(2):
        counts = _episode(tr, s0, 10, 30)
        runs.append((counts, tr.state.n_alive, tr.iteration,
                     [x.clone() for x in _tensors(tr)]))
    (ca, na, ia, ta), (cb, nb, ib, tb) = runs
    assert ca == cb and na == nb and ia == ib == 30
    assert ca["rounds"] == 2 and ca["resets"] == 1
    assert all(torch.equal(rounds.bits(x), rounds.bits(y))
               for x, y in zip(ta, tb))
    assert all(torch.equal(x, y) for x, y in zip(kept, s0.params))


def test_the_counters_of_a_short_episode(tmp_path):
    tr = _trainer(tmp_path)
    assert tr.counters() == dict.fromkeys(COUNTERS, 0)
    counts = _episode(tr, tr.state, 10, 20)
    # 11: no step pending; 12-20: the step before; 20: the flush before
    # the round and the round's info read; the reset's flush and the
    # log's find nothing pending
    assert counts["syncs"] == 9 + 1 + 1
    assert counts["rounds"] == 1 and counts["resets"] == 1
    assert counts["appended"] - counts["pruned"] == \
        tr.state.n_alive - 60
    assert counts["refires"] == counts["tier_grows"] == 0
    assert counts["capacity_grows"] == 0


def test_the_spans_of_a_profiled_episode(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer(tmp_path, max_instances=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counts = _episode(tr, tr.state, 15, 20)
    names = {e.name for e in prof.events()}
    for part in ("schedule", "camera", "dispatch", "verify", "round",
                 "reset", "refire"):
        assert "rain.trainer." + part in names, part
    assert counts["refires"] >= 1 and counts["tier_grows"] >= 1
    _episode(tr, tr.state, 15, 16)       # without a profiler: no range
    assert tr._profiling is False


# --- the cell through the harness, in a process of its own --------------
TINY = {"width": 48, "height": 32, "n_gaussians": 80, "capacity": 1024,
        "max_instances": 16384}


def tiny_root(tmp: Path) -> Path:
    """gsbench's data folders with the Trainer cell cut to TINY and its
    slice to iterations 20-40 (a round every 10, the reset at 30)."""
    root = tmp / "tiny"
    for d in ("traffic", "metrics", "workloads", "configs"):
        shutil.copytree(ROOT / "gsbench" / d, root / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "configs" / "garden_rain_262k.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["opt"].update(densification_interval=10, opacity_reset_interval=30,
                      densify_from_iter=5)
    path.write_text(json.dumps(cfg))
    path = root / "traffic" / "trainer_rain_slice.json"
    t = json.loads(path.read_text())
    t.update(first_iteration=20, last_iteration=40, warm_episodes=0)
    path.write_text(json.dumps(t))
    return root


RUNS = f"""
import json, sys, torch
from pathlib import Path
from gsbench import run
from gsbench.loops import trainer
torch.set_num_threads(1)
root = Path(sys.argv[1])
for name in [None, *trainer.FAULTS, "trace"]:
    fault = trainer.FAULTS.get(name)
    r, _ = run.run_cell({CELL!r}, {SEED}, 0.01, name == "trace",
                        torch.device("cpu"), root=root, fault=fault)
    print(json.dumps({{"name": name, **r}}), flush=True)
"""


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("cell"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", RUNS, str(root)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["name"]: r for r in map(json.loads,
                                      out.stdout.strip().splitlines())}


def test_a_sound_run_of_the_cell_is_correct(cell_runs):
    r = cell_runs[None]
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 20 and r["attempted"] % 20 == 0
    assert set(r["metrics"]) == {"train_ms_per_iter", "peak_mem_gib",
                                 "setup_s"}
    assert r["checks"]["round.counts"]["value"] == 0.0


@pytest.mark.parametrize("fault", sorted(trainer_loop.FAULTS))
def test_a_planted_fault_is_not_correct(cell_runs, fault):
    r = cell_runs[fault]
    assert not r["correct"], r["checks"]


def test_a_traced_run_reads_the_cell_metrics(cell_runs):
    r = cell_runs["trace"]
    assert r["correct"] and r["attempted"] == 20
    metrics = r["metrics"]
    # 21 and 31 find no step pending (the round's flush at 30 verified
    # its step); 22-30 and 32-40 verify the step before; each round adds
    # its flush and its info read: 18 + 2·2
    assert metrics["trainer.syncs_per_iter"]["value"] == 22 / 20
    assert metrics["device.idle_pct.trainer"]["value"] == 100.0
    # on the CPU no graph is replayed, so no mark is there to read
    assert "trainer.round_ms" not in metrics
    assert not any(k.endswith((".train", ".render")) or
                   k.startswith(("kernel.", "step_mfu")) for k in metrics)


def test_the_round_reader_reads_begin_to_round():
    def op(name, start, dur=1.0):
        return trace_mod.Op(name, start, dur, True, None)
    ops = [op("rain_mark_begin", 0.0), op("k", 2.0, 5.0),
           op("rain_mark_preprocess", 8.0),            # a step's marks
           op("rain_mark_begin", 100.0), op("round_kernel", 102.0, 3000.0),
           op("rain_mark_round", 3201.0),
           op("rain_mark_begin", 4000.0), op("rain_mark_reset", 4010.0),
           op("rain_mark_begin", 5000.0), op("rain_mark_round", 9001.0)]
    tr = trace_mod.Trace("trainer", ops, {}, 1.0, 0.5, [], [])
    assert trainer_trace.rounds_us(tr) == [3100.0, 4000.0]
    assert trainer_trace.round_ms(tr) == pytest.approx(3.55)
    assert trainer_trace.round_ms(tr._replace(kind="train")) is None


# --- the cell's inputs ----------------------------------------------------
def test_dead_leaves_are_seeded_and_painted_disc_by_disc(monkeypatch):
    kw = dict(coverage=3.0, r_min=2.0, r_max=9.0)
    a = trainer_loop.dead_leaves(2, 24, 40, 5, "cpu", **kw)
    assert a.shape == (2, 3, 24, 40) and 0.0 <= a.min() <= a.max() <= 1.0
    assert torch.equal(a, trainer_loop.dead_leaves(2, 24, 40, 5, "cpu",
                                                   **kw))
    assert not torch.equal(a, trainer_loop.dead_leaves(2, 24, 40, 6, "cpu",
                                                       **kw))
    # flat patches with edges: far fewer colours than pixels
    assert 10 < torch.unique(a[0].reshape(3, -1).T, dim=0).shape[0] < 300
    monkeypatch.setattr(trainer_loop, "LEAVES_BLOCK", 1)
    assert torch.equal(a, trainer_loop.dead_leaves(2, 24, 40, 5, "cpu",
                                                   **kw))


def test_the_extent_is_nerfpp_norm_of_the_ring():
    from gsbench import trainer_program as tp
    from gsbench.reference import schedules as ref_sched
    cfg = json.loads((ROOT / "gsbench" / "configs" /
                      "garden_rain_262k.json").read_text())
    ring = trainer_loop.ring(cfg)
    assert len(ring) == cfg["extent_ring"]
    cams = [tp.ring_camera(k, yaw, c, 1.0, 0.7)
            for k, (yaw, c) in enumerate(ring)]
    np.testing.assert_allclose(cams[0].camera_center, 0.0, atol=1e-6)
    pts = np.zeros((4, 3), np.float32)
    data = tp.scene(pts, pts, [], cams)
    want = ref_sched.scene_extent([c for _, c in ring])
    assert want == pytest.approx(1.1 * 0.5 * sum(cfg["box"]["z"]))
    assert data.nerf_radius == pytest.approx(want, rel=1e-6)


def test_the_start_is_held_to_the_plain_construction(tmp_path):
    from gsbench import run
    _, cfg, traffic = run.cell_spec(CELL)
    cfg = {**cfg, **TINY}
    loop = trainer_loop.Loop(cfg, traffic, SEED, torch.device("cpu"))
    loop.inputs()
    loop.tr = loop.tp.trainer(loop.scene, loop.configs(), str(tmp_path),
                              loop.dev)
    s0 = loop.tr.state
    n = s0.n_alive
    p0 = {k: v[:n] for k, v in loop.prog.params_of(s0).items()}
    assert loop.start_gap(p0) < 1e-6
    bad = trainer_loop.FAULTS["colours not in SH"]("start", s0)
    p1 = {k: v[:n] for k, v in loop.prog.params_of(bad).items()}
    assert loop.start_gap(p1) > 1e-2
