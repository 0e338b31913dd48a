"""Port parity: rain_tpu_torch.entry.entry against __graft_entry__.entry.

The forward render of 1,500 synthetic Gaussians (seed 0) at 256x192 from
create_from_pcd (capacity 2,048, KNN window 32), max_instances 32,768:
the same params and n_alive, and the same image at rain_tpu's forward
tolerances (rtol 1e-4, atol 3e-5). One JAX compilation, with the
compilation cache that __graft_entry__.entry turns on in a tmp path.
"""

import numpy as np
import torch

import jax

import __graft_entry__ as graft
from rain_tpu_torch import entry as tentry

torch.set_num_threads(1)


def test_entry_renders_as_rain_tpu(monkeypatch, tmp_path):
    monkeypatch.setenv("RAIN_TPU_COMPILE_CACHE", str(tmp_path / "xla"))
    jfn, (jparams, jn) = graft.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jn))
    fn, (params, n_alive) = tentry.entry("cpu")
    assert n_alive == int(jn) == tentry.N_GAUSS
    for name, a, b in zip(params._fields, params, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0.0, err_msg=name)
    got = fn(params, n_alive)
    assert got.shape == (3, tentry.HEIGHT, tentry.WIDTH) == want.shape
    assert got.device.type == "cpu" and float(got.std()) > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=3e-5)


def test_entry_is_deterministic_and_live_rows_only():
    """Two calls give the same bits; n_alive below the capacity leaves the
    dead rows out, as rain_tpu's alive mask does."""
    fn, (params, n_alive) = tentry.entry("cpu")
    assert torch.equal(fn(params, n_alive), fn(params, n_alive))
    fewer = fn(params, 500)
    assert not torch.equal(fewer, fn(params, n_alive))
    assert torch.isfinite(fewer).all()
