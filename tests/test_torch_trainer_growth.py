"""Port parity for the Trainer loop across a capacity growth: the port's
Trainer against rain_tpu's on the toy scene, with the harness and the
tolerances of tests/test_torch_trainer.py (see its docstring).

A white background, so the opacity also resets at densify_from_iter; the
first densify round asks for more rows than the capacity of 256 holds,
drops the excess and forces the growth to 4096; training goes on at the
grown capacity through two more rounds and a periodic opacity reset. JAX
compiles train_step at the two capacities, two compilations in all (the
tier of 8192 never overflows).
"""

import numpy as np

from test_torch_trainer import check_traces, run_pair, scenes  # noqa: F401


def test_trainer_trace_across_growth_matches_rain_tpu(monkeypatch, scenes,
                                                      tmp_path):
    jax_run, torch_run = run_pair(
        monkeypatch, scenes, tmp_path,
        opt=dict(iterations=30, densify_from_iter=5,
                 densification_interval=10, densify_until_iter=40,
                 opacity_reset_interval=25),
        system=dict(capacity=256, max_instances=8192, seed=1, log_every=5),
        rain=dict(warmup_iter=12), model=dict(white_background=True))
    events = jax_run[1]["events"]
    resets = [e for e in events if e[0] == "reset"]
    assert [r[1] for r in resets] == [256, 4096]     # at 5 and at 25
    dens = [e for e in events if e[0] == "densify"]
    assert [d[1] for d in dens] == [256, 4096, 4096]
    assert dens[0][5][4] and not dens[1][5][4]       # the first overflowed
    assert [e for e in events if e[0] == "grow"] == [("grow", 256, 4096)]
    assert [d[3] for d in dens] == [True, False, False]     # abe_split
    assert [d[4] for d in dens] == [False, False, True]     # size threshold
    assert not any(s[1] for s in jax_run[1]["steps"])
    late = check_traces(jax_run, torch_run)
    assert np.isfinite(late)
