"""What a Trainer's loop did, recorded by wrapping the four names its
module calls: ``train_step``, ``densify_and_prune``, ``reset_opacity`` and
``grow_capacity``. The wrappers record each call and call through.

rain_tpu's Trainer and the port's call the same four names, so one
recorder serves both: tests/test_torch_trainer*.py compare the two traces,
and chip_smoke.py reads the port's on the card. It imports numpy and
torch only, and reads no device value while the loop runs (a step's
results and its camera are kept and read by ``events`` and ``steps``).
"""

import time

import numpy as np
import torch


class Patches:
    """``monkeypatch.setattr`` and its undo, for callers outside pytest."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        self._saved = []


def _untimed(fn, *a, **kw):
    return fn(*a, **kw), None


def record(setattr_, step_mod, densify_mod, gaussians_mod, *,
           before_densify=None, timer=None):
    """Wrap the four names in the modules given, through ``setattr_``
    (``monkeypatch.setattr`` or ``Patches.setattr``). ``step_mod`` is what
    holds the ``train_step`` the Trainer reaches: a step module, or the
    port's ``compiled.CompiledStep`` class, whose method the Trainer calls
    (on the card its replays never reach the step module). Returns the
    trace, a dict that fills as the loop runs:

    - "calls": in call order, ("step", world_view, xyz_lr, sh_degree,
      low_pass, update_densify_stats, max_instances, capacity, width,
      height, n_alive), ("densify", capacity, n_alive, abe_split,
      use_size_threshold, DensifyInfo), ("reset", capacity, n_alive) and
      ("grow", capacity, new_capacity); a step's camera is its world_view
      array, and its xyz_lr, low_pass and n_alive as given, all unread
      (``calls`` reads them);
    - "aux": each step's StepAux, unread;
    - "t": the host clock (s) as each step was called;
    - "ms": {index in "calls": ms} of each densify round and growth, with
      ``timer(fn, *a, **kw) -> (out, ms)``.

    ``before_densify(state, kw)`` is called before each round.
    """
    trace = {"calls": [], "aux": [], "t": [], "ms": {}}
    run = timer or _untimed
    step0, dens0, reset0, grow0 = (
        step_mod.train_step, densify_mod.densify_and_prune,
        densify_mod.reset_opacity, gaussians_mod.grow_capacity)

    def train_step(*a, **kw):
        # (a method's self first)
        state, opt, camera, gt, bg, low_pass, xyz_lr = a[-7:]
        trace["t"].append(time.perf_counter())
        out = step0(*a, **kw)
        trace["calls"].append((
            "step", camera["world_view"], xyz_lr, kw["sh_degree"], low_pass,
            kw["update_densify_stats"], kw["max_instances"], state.capacity,
            kw["width"], kw["height"], state.n_alive))
        trace["aux"].append(out[2])
        return out

    def densify_and_prune(state, opt, key_or_noise, **kw):
        if before_densify is not None:
            before_densify(state, kw)
        out, ms = run(dens0, state, opt, key_or_noise, **kw)
        _timed_call(("densify", state.capacity, int(state.n_alive),
                     kw["abe_split"], kw["use_size_threshold"], out[2]), ms)
        return out

    def reset_opacity(state, opt):
        trace["calls"].append(("reset", state.capacity, int(state.n_alive)))
        return reset0(state, opt)

    def grow_capacity(state, new_capacity):
        out, ms = run(grow0, state, new_capacity)
        _timed_call(("grow", state.capacity, new_capacity), ms)
        return out

    def _timed_call(call, ms):
        if ms is not None:
            trace["ms"][len(trace["calls"])] = ms
        trace["calls"].append(call)

    setattr_(step_mod, "train_step", train_step)
    setattr_(densify_mod, "densify_and_prune", densify_and_prune)
    setattr_(densify_mod, "reset_opacity", reset_opacity)
    setattr_(gaussians_mod, "grow_capacity", grow_capacity)
    return trace


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def calls(trace):
    """The trace's calls with each step's xyz_lr and low_pass read as f32
    values and its n_alive as an int."""
    out = []
    for call in trace["calls"]:
        if call[0] == "step":
            f32 = [float(np.float32(_host(call[i]))) for i in (2, 4)]
            call = call[:2] + (f32[0], call[3], f32[1]) + call[5:10] + \
                (int(_host(call[10])),)
        out.append(call)
    return out


def events(trace, scene):
    """The trace's calls as plain values, read now (``calls``): each
    step's camera as its uid in ``scene``, each round's DensifyInfo as
    (n_cloned, n_split, n_pruned, n_alive, overflow) ints and a bool."""
    uid_of = {np.float32(c.world_view).tobytes(): c.uid
              for c in scene.train_cameras + scene.test_cameras}
    out = []
    for call in calls(trace):
        if call[0] == "step":
            wv = _host(call[1]).astype(np.float32).tobytes()
            call = (call[0], uid_of[wv]) + call[2:]
        elif call[0] == "densify":
            info = call[5]
            call = call[:5] + (tuple(int(x) for x in info[:4]) +
                               (bool(info[4]),),)
        out.append(call)
    return out


def steps(trace):
    """(loss, instance_overflow, num_instances) of every step, read now."""
    return [(float(_host(a.loss)), bool(_host(a.instance_overflow)),
             int(_host(a.num_instances))) for a in trace["aux"]]
