"""A cell of several cards at tiny sizes on the CPU: two ranks over gloo
run the multi-rank path of ``run.run_ranks`` end to end; faults planted
on the ranks make the run incorrect; ranks that report the same card
twice fail the run without a result; the reference's fullest band is the
count of its clipped rectangles; the control fails the cell's limits; a
one-card cell's result keeps its keys."""

import json

import pytest
import torch

from gsbench import camera, check, ranks, run
from gsbench.loops import sharded_train
from gsbench.reference import bands
from gsbench.reference.preprocess import TILE, screen
from gsbench.tests.conftest import tiny_root
from gsbench.tests.test_gsbench_harness import _unchanged

CPU = torch.device("cpu")
SEED = 2**31 + 23
CELL = "largescene16m.train"
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The tiny data root with the four-card cell cut to two ranks."""
    root = tiny_root(tmp_path_factory.mktemp("multicard"))
    path = root / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    path.write_text(json.dumps({**cell, "chips": 2}))
    return root


def _run(root, trace=False, fault=None):
    result, lines = run.run_ranks(CELL, SEED, 0.5, trace, CPU, root=root,
                                  fault=fault)
    return result, lines


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_run_correct_on_two_devices(two_ranks, trace):
    result, lines = _run(two_ranks, trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["device"]["count"] == 2
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    ranked = next(line["ranks"] for line in lines if "ranks" in line)
    assert [r[0] for r in ranked] == [0, 1]
    if trace:
        assert result["device"]["window_s"] > 0
        assert "setup_s" not in result["metrics"]
        assert "collective.nccl_ms.train" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"train_ms_per_iter",
                                          "peak_mem_gib", "setup_s"}


def _unchanged_on_rank_1(rank, loop):
    if rank == 1:
        loop.fault = _unchanged


def _no_exchange(rank, loop):
    loop.prog.leave_out_exchange()


def _half_the_rows(rank, loop):
    from rain_tpu_torch.parallel import sharding
    whole = sharding._band_loss_sums

    def half(color, gt, band_ty0, rows_per_band, **kw):
        keep = color.shape[1] // 2
        return whole(color[:, :keep], gt[:, :keep], band_ty0,
                     rows_per_band, **kw)
    sharding._band_loss_sums = half


@pytest.mark.parametrize("fault", [_unchanged_on_rank_1, _no_exchange,
                                   _half_the_rows])
def test_a_fault_planted_on_the_ranks_is_not_correct(two_ranks, fault):
    result, _ = _run(two_ranks, fault=fault)
    assert not result["correct"], result["checks"]


def _report(card, peak, kind="NVIDIA H100 80GB HBM3"):
    return {"card": card, "peak_bytes": peak, "kind": kind}


def test_the_devices_are_the_distinct_cards_and_the_fullest_peak():
    reports = [_report(f"0000:{b:02x}:00", p)
               for b, p in ((0x18, 5), (0x2a, 9), (0x3a, 7), (0x5d, 1))]
    dev = ranks.devices(reports, 4)
    assert dev == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4, "memory_peak_bytes": 9}


@pytest.mark.parametrize("reports", [
    [_report("0000:18:00", 1), _report("0000:18:00", 1),
     _report("0000:2a:00", 1), _report("0000:3a:00", 1)],
    [_report("0000:18:00", 1), _report("0000:2a:00", 1, "other"),
     _report("0000:3a:00", 1), _report("0000:5d:00", 1)]])
def test_ranks_on_too_few_cards_fail_the_run(reports):
    with pytest.raises(ranks.WrongDevices):
        ranks.devices(reports, 4)


def test_the_command_prints_no_result_when_a_card_is_named_twice(
        monkeypatch, capsys):
    twice = [_report("0000:18:00", 1)] * 2 + \
        [_report("0000:2a:00", 1), _report("0000:3a:00", 1)]

    def fake(*args, **kwargs):
        ranks.devices(twice, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_ranks", fake)
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "ran on 3" in out.err


def _tiny_screen(root, seed):
    loop = sharded_train.Loop(*run.cell_spec(CELL, root)[1:], seed, CPU,
                              None, world=4)
    loop.inputs()
    cfg = loop.cfg
    cam = camera.pick(loop.cams, 0)
    return cfg, screen(loop.p0, cam, width=cfg["width"],
                       height=cfg["height"], sh_degree=cfg["sh_degree"],
                       low_pass=0.3)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_the_fullest_band_counts_the_clipped_rectangles(two_ranks, world):
    cfg, s = _tiny_screen(two_ranks, SEED)
    grid_y = (cfg["height"] + TILE - 1) // TILE
    rows = -(-grid_y // world)
    direct = [0] * world
    for g in range(s.tiles.shape[0]):
        if int(s.tiles[g]) == 0:
            continue
        x0, y0 = (int(v) for v in s.rect_min[g])
        w, h = (int(v) for v in s.rect_wh[g])
        for y in range(y0, y0 + h):
            for b in range(world):
                if b * rows - 1 <= y < (b + 1) * rows + 1:
                    direct[b] += w
    assert sum(direct) > 0
    assert bands.band_counts(s, cfg["height"], world) == direct
    assert bands.fullest(s, cfg["height"], world) == max(direct)


def test_the_control_fails_the_sharded_limits(two_ranks):
    from gsbench import calibrate
    cell, cfg, traffic = run.cell_spec(CELL, two_ranks)
    loop = sharded_train.Loop(cfg, traffic, SEED, CPU, None, world=2)
    loop.inputs()
    r32 = loop.reference(loop.p0)
    bf16 = loop.reference({k: v.to(torch.bfloat16)
                           for k, v in loop.p0.items()})
    half = loop.reference(loop.p0, loss_fn=calibrate.half_rows_loss)
    limits = cell["limits"]
    for rec in (bf16, half):
        numbers = check.train_numbers(rec, r32)
        assert any(numbers[k] > limits[k] for k in limits), numbers


def test_a_one_card_result_keeps_its_keys(tiny):
    result, _ = run.run_cell("garden4m.train", SEED, 0.5, False, CPU,
                             root=tiny)
    assert list(result) == KEYS
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}
    assert set(result["metrics"]) == {"train_ms_per_iter", "peak_mem_gib",
                                      "setup_s"}
