"""Configuration: dataclass groups + auto-generated argparse flags.

A copy of rain_tpu/config.py (standard library only) with the same
groups, flag names, shorthands and defaults, so that one command line
configures either package. Counterpart of the reference ParamGroup
reflection system (arguments/__init__.py:9-102), persisted as JSON instead
of a re-``eval()``-ed Namespace string (the reference's cfg_args
mechanism, arguments/__init__.py:95).

The port adds depth regularization's flags (graphdeco-inria/
gaussian-splatting's 2024 update: ModelParams ``-d/--depths``,
OptimizationParams ``depth_l1_weight_init`` / ``_final``), which
rain_tpu lacks (``PORT_ONLY``). ``save_config`` leaves them out while
they hold their defaults, so a configuration that does not use them is
saved as rain_tpu saves it and loads in either package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields
from pathlib import Path


def _add_group(parser: argparse.ArgumentParser, cfg, name: str,
               shorthands: set[str], suppress: bool = False):
    group = parser.add_argument_group(name)
    for f in fields(cfg):
        flag = "--" + f.name
        default = getattr(cfg, f.name)
        if suppress:
            default = argparse.SUPPRESS
        names = [flag]
        if f.name in shorthands:
            names.append("-" + f.name[0])
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            t = type(getattr(cfg, f.name)) if getattr(cfg, f.name) \
                is not None else str
            group.add_argument(*names, default=default, type=t)


def _extract(cfg_cls, args: argparse.Namespace):
    kwargs = {f.name: getattr(args, f.name) for f in fields(cfg_cls)
              if hasattr(args, f.name)}
    return cfg_cls(**kwargs)


@dataclass
class ModelParams:
    """Reference ModelParams (arguments/__init__.py:37-52)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    # upstream's depth regularization: the folder of 16-bit inverse depth
    # maps, one PNG per image ("" = no depth term)
    depths: str = ""

    SHORTHANDS = {"source_path", "model_path", "images", "resolution",
                  "white_background", "depths"}


@dataclass
class PipelineParams:
    """Reference PipelineParams (arguments/__init__.py:54-59).

    convert_SHs_python / compute_cov3D_python are accepted for CLI
    compatibility but are no-ops: the reference uses them to switch
    between CUDA-kernel and PyTorch implementations of SH evaluation and
    covariance construction, and here both are the same PyTorch code.
    ``debug`` enables the non-finite-loss state dump (the counterpart of
    the reference snapshot dumps).
    """
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # the reference --detect_anomaly (train.py:234,295 →
    # torch.autograd.set_detect_anomaly)
    detect_anomaly: bool = False

    SHORTHANDS = frozenset()


@dataclass
class OptimizationParams:
    """Reference OptimizationParams (arguments/__init__.py:61-80)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    # the depth term's weight, log-linear from init to final over the
    # iterations (upstream's train.py)
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01

    SHORTHANDS = frozenset()


@dataclass
class RainParams:
    """RAIN-GS method flags + ours extras (reference train.py:244-253)."""
    c2f: bool = False
    c2f_every_step: float = 1000.0
    c2f_max_lowpass: float = 300.0
    num_gaussians: int = 1_000_000
    paper_random: bool = False
    ours: bool = False
    ours_new: bool = False
    warmup_iter: int = 0
    train_from: str = "random"     # random|reprojection|cluster|noisy_sfm
    num_cams: int = 10

    SHORTHANDS = frozenset()


@dataclass
class SystemParams:
    """Knobs of the fixed-capacity design (no reference counterpart)."""
    capacity: int = 0              # 0 = auto (grown on demand)
    max_capacity: int = 0          # 0 = unlimited; else capacity growth
    #   stops at this bound (densify rounds that would overflow it drop
    #   their appends — a logged memory budget rail for production runs)
    max_instances: int = 0         # 0 = auto
    devices: int = 1               # 1 = one device; N > 1 = sharded over
    #   the N ranks of a torch.distributed group; 0 = its world size
    log_every: int = 10
    seed: int = 0
    camera_cache: int = 0          # max GT images kept on the device (0 = all)
    profile_steps: str = ""        # "A-B": capture a profiler trace over
    #   iterations [A, B] to <model_path>/profile/ (the counterpart of the
    #   reference's iter_time-only timing, train.py:47-48,183)
    pipeline: int = 1              # 1: verify each step's overflow/NaN
    #   flags one step late, so that the host queues the next step before
    #   it waits (rolls back + replays on a late overflow); 0: synchronous
    #   per-step verification

    SHORTHANDS = frozenset()


GROUPS = {
    "model": ModelParams,
    "pipeline": PipelineParams,
    "opt": OptimizationParams,
    "rain": RainParams,
    "system": SystemParams,
}
# the port's fields that rain_tpu's groups lack
PORT_ONLY = {"model": ("depths",),
             "opt": ("depth_l1_weight_init", "depth_l1_weight_final")}


def build_parser(description: str,
                 groups=("model", "pipeline", "opt", "rain", "system")):
    parser = argparse.ArgumentParser(description=description)
    for g in groups:
        cls = GROUPS[g]
        _add_group(parser, cls(), g, set(getattr(cls, "SHORTHANDS", ())))
    return parser


def extract_all(args: argparse.Namespace) -> dict:
    return {name: _extract(cls, args) for name, cls in GROUPS.items()}


def apply_method_presets(cfgs: dict, source_path: str = "") -> dict:
    """Reference meta-flag rewrites (train.py:261-280):
    scene-name image-dir selection and the --ours/--ours_new presets."""
    model = cfgs["model"]
    rain = cfgs["rain"]
    outdoor = ["bicycle", "flowers", "garden", "stump", "treehill"]
    indoor = ["room", "counter", "kitchen", "bonsai"]
    images = model.images
    for s in outdoor:
        if s in source_path:
            images = "images_4"
    for s in indoor:
        if s in source_path:
            images = "images_2"
    model = dataclasses.replace(model, images=images)
    if rain.ours or rain.ours_new:
        rain = dataclasses.replace(rain, c2f=True, c2f_every_step=1000.0,
                                   c2f_max_lowpass=300.0, num_gaussians=10)
    if rain.ours_new:
        rain = dataclasses.replace(rain, warmup_iter=10000)
    return dict(cfgs, model=model, rain=rain)


def explicit_flag_names(argv,
                        groups=("model", "pipeline", "opt", "rain",
                                "system")) -> set[str]:
    """Group-config flag names explicitly present on the command line.

    Re-parses ``argv`` with every default set to ``argparse.SUPPRESS`` so
    the resulting namespace holds exactly the flags the user typed —
    the mechanism behind reference ``get_combined_args`` semantics
    (arguments/__init__.py:82-102: any explicitly-passed CLI flag beats
    the saved config).
    """
    import sys
    if argv is None:
        argv = sys.argv[1:]
    probe = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    for g in groups:
        cls = GROUPS[g]
        _add_group(probe, cls(), g, set(getattr(cls, "SHORTHANDS", ())),
                   suppress=True)
    ns, _ = probe.parse_known_args(argv)
    return set(vars(ns))


def merge_saved(cfgs: dict, loaded: dict, explicit: set[str]) -> dict:
    """Merge a saved config under CLI values: saved values win except for
    flags the user explicitly passed (reference get_combined_args,
    arguments/__init__.py:82-102)."""
    merged = dict(cfgs)
    for name, saved_cfg in loaded.items():
        if name not in merged:
            merged[name] = saved_cfg
            continue
        cli_cfg = merged[name]
        overrides = {f.name: getattr(cli_cfg, f.name)
                     for f in fields(saved_cfg) if f.name in explicit}
        merged[name] = dataclasses.replace(saved_cfg, **overrides)
    return merged


def save_config(cfgs: dict, path: str | Path):
    """Write ``cfgs`` as JSON; the ``PORT_ONLY`` fields only where they
    differ from their defaults."""
    payload = {}
    for name, cfg in cfgs.items():
        d = dataclasses.asdict(cfg)
        for f in PORT_ONLY.get(name, ()):
            if d[f] == getattr(type(cfg)(), f):
                del d[f]
        payload[name] = d
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(payload, indent=2))


def load_config(path: str | Path) -> dict:
    payload = json.loads(Path(path).read_text())
    return {name: GROUPS[name](**vals) for name, vals in payload.items()
            if name in GROUPS}
