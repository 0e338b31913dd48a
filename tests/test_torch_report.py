"""The port's Trainer reports: a report view never scores a truncated image.

A view with more instances than the training tier is rendered again at the
first ladder tier that holds it (``Trainer._report_render``), while the
training tier, which shapes the training schedule, stays as it is. The
toy scene of tests/test_torch_trainer_port.py; no JAX.
"""

import pytest
import torch

from rain_tpu_torch.train import trainer as trainer_mod
from test_torch_trainer_port import configs, make_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _report(scene, tmp_path, max_instances):
    logs = []
    tr = trainer_mod.Trainer(
        scene, configs({}, dict(max_instances=max_instances)),
        str(tmp_path / str(max_instances)), device="cpu",
        log_fn=logs.append, tensorboard=False)
    return tr, tr.report(0), logs


def test_report_renders_an_overflowing_view_again(scene, tmp_path):
    ample, want, ample_logs = _report(scene, tmp_path, 1 << 16)
    assert ample.report_rerenders == []
    assert not any("rendered again" in line for line in ample_logs)

    small, got, logs = _report(scene, tmp_path, 64)
    # every view holds far more than 64 instances: each was rendered again
    views = len(scene.test_cameras) + 5
    assert len(small.report_rerenders) == views
    for it, name, tier, again in small.report_rerenders:
        assert (it, tier) == (0, 64) and again > tier
        line = next(x for x in logs if f"report view {name}:" in x)
        assert f"the tier {tier}; rendered again at {again}" in line
    # the whole image is scored: the same metrics as at an ample tier, to
    # every bit, and the training tier is left alone
    assert got == want
    assert small.max_instances == 64


def test_fitting_tier_climbs_the_ladder():
    assert trainer_mod._fitting_tier(64, 0) == 96
    assert trainer_mod._fitting_tier(64, 1000) == 1024
    m = 64
    while m < 1000:
        m = trainer_mod._next_instance_tier(m)
    assert trainer_mod._fitting_tier(64, 1000) == m
    with pytest.raises(MemoryError):
        trainer_mod._fitting_tier(64, trainer_mod.MAX_INSTANCE_TIER + 1)
