"""The port's scaling sweep (parallel.scaling) and the graft entry's
dryrun_multichip and scaling_sweep (rain_tpu_torch.entry) on the CPU, one
gloo process per rank, as tests/test_sharding.py:141-155 runs rain_tpu's
sweep. No JAX."""

import numpy as np
import pytest
import torch

from rain_tpu_torch import entry
from rain_tpu_torch.parallel import scaling

torch.set_num_threads(1)

SMALL = dict(width=64, height=64, n_gaussians=512, iters=1)


def test_scaling_sweep_runs():
    msgs = []
    res = scaling.scaling_sweep([1, 2], device="cpu", log_fn=msgs.append,
                                **SMALL)
    assert [r["n_dev"] for r in res] == [1, 2]
    for r in res:
        assert set(r) == {"n_dev", "steps_per_s", "mpix_per_s", "efficiency"}
        assert np.isfinite(r["steps_per_s"]) and r["steps_per_s"] > 0
        assert np.isfinite(r["efficiency"]) and r["efficiency"] > 0
    assert res[0]["efficiency"] == 1.0
    assert len(msgs) == 2


def test_entry_scaling_sweep_counts_in_powers_of_two():
    res = entry.scaling_sweep(3, device="cpu", log_fn=lambda *a: None,
                              **SMALL)
    assert [r["n_dev"] for r in res] == [1, 2]


def test_dryrun_multichip_on_the_cpu(capsys):
    out = entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(out["loss"]) and out["denom_sum"] > 0
    assert 0 < out["num_instances"] <= entry.DRYRUN_TIER
    assert capsys.readouterr().out.endswith(
        f"dryrun_multichip(2): loss={out['loss']:.5f} OK\n")


def test_too_few_cards_raise():
    """No fall back to a CPU group: ranks on cards need a card each, or
    share_device=True (this sandbox has none; the chip machine one)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(2)
