"""rain-tpu in PyTorch and CUDA: the Trainer, the training step, the render.

A port of the JAX package ``rain_tpu`` (which stays beside it as the
reference) to PyTorch on an NVIDIA H100. Its layout mirrors the
reference's, module by module:

  config   — the configuration groups and their command-line flags.
  data/    — camera math, PLY interchange (byte-compatible files), image
             files (PNG without PIL), COLMAP parsing, the COLMAP and
             Blender scene loaders.
  native/  — the C COLMAP parser, built with cc at first use.
  eval/    — LPIPS.
  viewer/  — the SIBR live-viewer bridge.
  scripts/ — the train, render and metrics CLIs (``--device``).
  model/   — the fixed-capacity Gaussian state (with its KNN init and
             growth) and its activations, Adam, densification: the
             statistics, clone / split / prune, the opacity reset.
  ops/     — preprocess (projection, SH), tile binning with the instance
             expansion and reduction kernels, the tile compositor's
             forward and backward kernels, image assembly, the losses,
             the KNN.
  train/   — the ``Trainer`` loop and its schedules, ``train_step``,
             ``eval_render``, npz checkpoints and PLY snapshots.
  csrc/    — the hand-written CUDA C++ kernels (sm_90a), built by
             ``_build`` with nvcc at first use.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise. Each kernel wrapper picks its
path from its input's device: a CPU tensor runs the plain PyTorch version,
a CUDA tensor launches the kernel.

The package imports torch, numpy and the standard library (and PIL where
a JPEG or a resize needs it) — never ``jax`` or ``rain_tpu``.
"""

import torch

# The reference pins every f32 product to full precision
# (rain_tpu/ops/projection.py:31-34); TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
