"""Preprocess from the raw parameters: one CUDA kernel each way, and its
plain version.

``preprocess(params, alive, ...)`` takes a Gaussian state's six raw
leaves (model.gaussians.GaussianParams: xyz, features_dc, features_rest,
scaling, rotation, opacity) and returns ops.projection.Preprocessed: the
activation (``gaussians.activate``), the projection, the rects and the SH
colours in one step, differentiable in the six leaves.

The path follows the tensors' device, as every kernel wrapper's does:

- a CPU state runs the plain version, ``preprocess_torch``:
  ``gaussians.activate`` followed by ``projection.preprocess``, in plain
  torch ops under autograd;
- a CUDA state runs the autograd Function ``_Preprocess``, whose forward
  is the kernel of ``csrc/preprocess_fwd.cu`` (``preprocess_forward``) and
  whose backward is the kernel of ``csrc/preprocess_bwd.cu``
  (``preprocess_backward``). The two share the per-Gaussian math in
  ``csrc/preprocess.cuh``. The forward rounds as the plain version does
  on the card, so its outputs equal the plain version's bit for bit; the
  backward takes the plain version's autograd graph by hand, recomputing
  every intermediate from the raw leaves, and writes the six leaves'
  gradients once each (no accumulation, no fills, nothing kept from the
  forward): its gradients equal autograd's to rounding.

Neither kernel replaces a Pallas kernel: rain_tpu left this stage to XLA,
which fused it; here the plain version is some 420 kernels forward and
770 backward at the main path's sizes, each a pass over N rows.

Every per-call value (the camera's matrices, centre and tan(fov/2),
``low_pass``, ``scale_modifier`` and the true ``width``/``height``) is
read by the kernels from device memory: a number becomes a 0-d device
tensor first (a fill), so a captured graph reads each call's values.
The SH degree (0..4) selects the kernels' instantiation; ``grid`` and
``tight_opacity_culling`` are launch arguments.

Each wrapper counts its launches in ``.launches``: one forward launch per
frame or step, one backward launch per training step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rain_tpu_torch import _build
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import projection as proj_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_DEGREE = 4
# features_rest's rows a kernel takes: a degree-4 state's (csrc's shared
# memory holds 128 such rows)
MAX_REST = (MAX_DEGREE + 1) ** 2 - 1


class CallValues(NamedTuple):
    """The per-call values as the kernels read them: 0-d or small device
    tensors (f32, but the int32 size)."""

    world_view: torch.Tensor      # [4, 4]
    full_proj: torch.Tensor       # [4, 4]
    camera_center: torch.Tensor   # [3]
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    low_pass: torch.Tensor
    scale_modifier: torch.Tensor
    width: torch.Tensor           # int32: the true size
    height: torch.Tensor


def call_values(camera: dict, width, height, low_pass, scale_modifier,
                device: torch.device) -> CallValues:
    """``CallValues`` on ``device``: tensors are converted where they lie,
    numbers filled on the device (``device.scalar``). Raises ValueError on
    a tensor of another shape or device."""
    f32, i32 = torch.float32, torch.int32
    cam = [camera["world_view"], camera["full_proj"],
           camera["camera_center"], camera["tanfovx"], camera["tanfovy"]]
    cam = [device_mod.scalar(v, f32, device).contiguous() for v in cam]
    vals = CallValues(
        *cam, device_mod.scalar(low_pass, f32, device),
        device_mod.scalar(scale_modifier, f32, device),
        device_mod.scalar(width, i32, device),
        device_mod.scalar(height, i32, device))
    shapes = ((4, 4), (4, 4), (3,)) + ((),) * 6
    for name, v, shape in zip(CallValues._fields, vals, shapes):
        if tuple(v.shape) != shape or v.device.type != device.type or \
                device.index not in (None, v.device.index):
            raise ValueError(f"{name} must be a {shape} tensor on {device}, "
                             f"got {tuple(v.shape)} on {v.device}")
    return vals


def _check(params: gmod.GaussianParams, sh_degree: int) -> int:
    """N, after checking the leaves' dtypes, shapes, device and layout."""
    n = params.xyz.shape[0]
    rest = params.features_rest.shape[1] if params.features_rest.dim() == 3 \
        else -1
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
              "features_rest": (n, rest, 3), "scaling": (n, 3),
              "rotation": (n, 4), "opacity": (n, 1)}
    dev = params.xyz.device
    for name, t in zip(gmod.GaussianParams._fields, params):
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[name] or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shapes[name]} "
                             f"float32 tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= sh_degree <= MAX_DEGREE or \
            (sh_degree + 1) ** 2 - 1 > rest or rest > MAX_REST:
        raise ValueError(f"SH degree {sh_degree} with {rest} rest "
                         f"coefficients: the kernels take degrees 0..4 and "
                         f"at most {MAX_REST} rows")
    if 4 * n >= 2**31:   # the kernels index rotation's rows as 4 g, int32
        raise ValueError(f"N = {n} must lie below 2^29")
    return n


def _pointers(params: gmod.GaussianParams, sh_degree: int, n: int):
    p = params
    return (n, sh_degree, p.xyz.data_ptr(), p.features_dc.data_ptr(),
            p.features_rest.data_ptr(), p.features_rest.shape[1],
            p.scaling.data_ptr(), p.rotation.data_ptr(),
            p.opacity.data_ptr())


def preprocess_forward(params: gmod.GaussianParams, alive: torch.Tensor,
                       vals: CallValues, *, sh_degree: int,
                       grid: tuple[int, int],
                       tight_opacity_culling: bool = True
                       ) -> proj_ops.Preprocessed:
    """The forward kernel (``csrc/preprocess_fwd.cu``) on CUDA leaves:
    ``preprocess_torch``'s outputs (same contract), every element written.
    ``alive`` [N] bool; ``vals`` from ``call_values``; ``grid`` the tile
    grid the rects are clamped to. Raises ValueError on leaves it does not
    take (see ``_check``)."""
    n = _check(params, sh_degree)
    dev = params.xyz.device
    if alive.dtype != torch.bool or alive.shape != (n,) or \
            alive.device != dev or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous [{n}] bool tensor on "
                         f"{dev}")
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels run on CUDA, not {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = proj_ops.Preprocessed(
        xy=torch.empty((n, 2), **f32), depth=torch.empty((n,), **f32),
        conic=torch.empty((n, 3), **f32), rgb=torch.empty((n, 3), **f32),
        opacity=torch.empty((n,), **f32), radii=torch.empty((n,), **i32),
        rect_min=torch.empty((n, 2), **i32),
        rect_wh=torch.empty((n, 2), **i32),
        tiles_touched=torch.empty((n,), **i32))
    f = _build.kernel("preprocess_fwd", "rain_preprocess_forward", (
        _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, *[_P] * 9, _I, _I, _I,
        *[_P] * 9))
    _build.launch(f, dev, *_pointers(params, sh_degree, n), alive.data_ptr(),
                  *[v.data_ptr() for v in vals], int(grid[0]), int(grid[1]),
                  int(bool(tight_opacity_culling)),
                  *[t.data_ptr() for t in out])
    preprocess_forward.launches += 1
    return out


preprocess_forward.launches = 0


def preprocess_backward(params: gmod.GaussianParams, vals: CallValues, *,
                        sh_degree: int, d_xy, d_depth, d_conic, d_rgb,
                        d_opacity) -> gmod.GaussianParams:
    """The backward kernel (``csrc/preprocess_bwd.cu``) on CUDA leaves:
    the gradients of the six leaves (GaussianParams of new tensors, every
    element written) given the cotangents of Preprocessed's xy [N, 2],
    depth [N], conic [N, 3], rgb [N, 3] and opacity [N], each a tensor or
    None (zero). Raises ValueError on what it does not take."""
    n = _check(params, sh_degree)
    dev = params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels run on CUDA, not {dev}")
    cots = []
    for name, t, shape in (("d_xy", d_xy, (n, 2)), ("d_depth", d_depth, (n,)),
                           ("d_conic", d_conic, (n, 3)),
                           ("d_rgb", d_rgb, (n, 3)),
                           ("d_opacity", d_opacity, (n,))):
        if t is None:
            cots.append(None)
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape or \
                t.device != dev:
            raise ValueError(f"{name} must be a {shape} float32 tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)}")
        cots.append(t.contiguous())
    grads = gmod.GaussianParams(*[torch.empty_like(p) for p in params])
    f = _build.kernel("preprocess_bwd", "rain_preprocess_backward", (
        _I, _I, _P, _P, _P, _I, _P, _P, _P, *[_P] * 9, *[_P] * 5,
        *[_P] * 6))
    _build.launch(f, dev, *_pointers(params, sh_degree, n),
                  *[v.data_ptr() for v in vals],
                  *[None if t is None else t.data_ptr() for t in cots],
                  *[g.data_ptr() for g in grads])
    preprocess_backward.launches += 1
    return grads


preprocess_backward.launches = 0


class _Preprocess(torch.autograd.Function):
    """``preprocess`` on CUDA leaves: forward kernel, backward kernel. Only
    the six leaves take a gradient; the backward keeps the leaves and the
    per-call values, nothing else."""

    @staticmethod
    def forward(ctx, xyz, features_dc, features_rest, scaling, rotation,
                opacity, alive, vals, sh_degree, grid, tight):
        params = gmod.GaussianParams(xyz, features_dc, features_rest,
                                     scaling, rotation, opacity)
        out = preprocess_forward(params, alive, vals, sh_degree=sh_degree,
                                 grid=grid, tight_opacity_culling=tight)
        ctx.save_for_backward(*params, *vals)
        ctx.sh_degree = sh_degree
        ctx.mark_non_differentiable(out.radii, out.rect_min, out.rect_wh,
                                    out.tiles_touched)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_xy, d_depth, d_conic, d_rgb, d_opacity, *_ints):
        saved = ctx.saved_tensors
        n_leaves = len(gmod.GaussianParams._fields)
        grads = preprocess_backward(
            gmod.GaussianParams(*saved[:n_leaves]),
            CallValues(*saved[n_leaves:]), sh_degree=ctx.sh_degree,
            d_xy=d_xy, d_depth=d_depth, d_conic=d_conic, d_rgb=d_rgb,
            d_opacity=d_opacity)
        return (*grads, None, None, None, None, None)


def preprocess_torch(params: gmod.GaussianParams, alive: torch.Tensor, *,
                     sh_degree: int, camera: dict, width, height,
                     grid: tuple[int, int] | None = None, low_pass=0.3,
                     scale_modifier=1.0,
                     tight_opacity_culling: bool = True
                     ) -> proj_ops.Preprocessed:
    """The plain version (same contract as ``preprocess``), on any
    device: ``gaussians.activate``, then ``projection.preprocess``."""
    scales, quats, opac, shs = gmod.activate(params)
    return proj_ops.preprocess(
        params.xyz, scales, quats, opac, shs, alive, sh_degree=sh_degree,
        world_view=camera["world_view"], full_proj=camera["full_proj"],
        camera_center=camera["camera_center"], tan_fovx=camera["tanfovx"],
        tan_fovy=camera["tanfovy"], width=width, height=height,
        low_pass=low_pass, scale_modifier=scale_modifier, grid=grid,
        tight_opacity_culling=tight_opacity_culling)


def preprocess(params: gmod.GaussianParams, alive: torch.Tensor, *,
               sh_degree: int, camera: dict, width, height,
               grid: tuple[int, int], low_pass=0.3, scale_modifier=1.0,
               tight_opacity_culling: bool = True
               ) -> proj_ops.Preprocessed:
    """Screen quantities of every Gaussian from its raw parameters.

    Args:
      params: the six raw leaves (GaussianParams), differentiable.
      alive: [N] bool mask of the live capacity slots.
      sh_degree: the active SH degree, 0..4.
      camera: dict of data.cameras.Camera.render_inputs().
      width, height: the true image size (focal lengths, NDC -> pixels):
        ints or 0-d int32 device tensors.
      grid: the tile grid the rects are clamped to (a bucketed step's
        is its bucket's, wider than the true size's).
      low_pass, scale_modifier: numbers or 0-d f32 device tensors.
      tight_opacity_culling: as in projection.preprocess.

    Returns projection.Preprocessed, as ``preprocess_torch`` gives it. A
    CPU state runs ``preprocess_torch``; a CUDA state the kernels (see
    the module docstring); ValueError on any other device.
    """
    dev = params.xyz.device
    if dev.type == "cpu":
        return preprocess_torch(
            params, alive, sh_degree=sh_degree, camera=camera, width=width,
            height=height, grid=grid, low_pass=low_pass,
            scale_modifier=scale_modifier,
            tight_opacity_culling=tight_opacity_culling)
    if dev.type != "cuda":
        raise ValueError(f"no preprocess for device {dev}")
    vals = call_values(camera, width, height, low_pass, scale_modifier, dev)
    return proj_ops.Preprocessed(*_Preprocess.apply(
        *params, alive, vals, int(sh_degree), tuple(grid),
        bool(tight_opacity_culling)))
