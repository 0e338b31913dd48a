"""A stand-in for the ``sam2`` package, for both packages' SAM2 tools.

``modules(calls)`` gives the ``sys.modules`` entries of a fake ``sam2``:
``build_sam2``, ``build_sam2_video_predictor`` and
``SAM2AutomaticMaskGenerator`` record each call in ``calls`` (devices as
strings, tensors as numpy arrays), the mask generator draws seeded
rectangles from the image it is given, and the video predictor's
``propagate_in_video`` yields seeded logits for every frame. The same
image gives the same masks and the same frame the same logits, whichever
package calls.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

N_MASKS = 5
IMAGE_SIZE = 64          # the predictor's input size: prompts at 16x16
FRAME_EXTS = (".jpg", ".jpeg", ".png")


def _masks(image: np.ndarray, n: int = N_MASKS):
    """``n`` seeded rectangles of ``image``'s size; the second is the
    first one row down, a tie in area that the sort must keep in order."""
    h, w = image.shape[:2]
    rng = np.random.default_rng(int(image.astype(np.int64).sum()) % 2**32)
    rects = [(rng.integers(0, h // 2), rng.integers(0, w // 2),
              rng.integers(1, h // 2 + 1), rng.integers(1, w // 2 + 1))
             for _ in range(n)]
    y0, x0, dy, dx = rects[0]
    rects[1] = (y0 + 1, x0, dy, dx)
    out = []
    for y0, x0, dy, dx in rects:
        seg = np.zeros((h, w), bool)
        seg[y0:y0 + dy, x0:x0 + dx] = True
        out.append({"segmentation": seg, "area": int(seg.sum())})
    return out


class _Generator:
    def __init__(self, calls, model=None, **kwargs):
        self.calls = calls
        calls.append(("SAM2AutomaticMaskGenerator", model is not None,
                      kwargs))

    def generate(self, image):
        self.calls.append(("generate", image.shape, image.dtype.str,
                           int(image.astype(np.int64).sum())))
        return _masks(image)


class _Predictor:
    image_size = IMAGE_SIZE

    def __init__(self, calls, device):
        self.calls, self.device = calls, torch.device(device)
        self.objects = []

    def parameters(self):
        yield torch.zeros(1, device=self.device)

    def init_state(self, video_path):
        self.calls.append(("init_state", video_path))
        frames = sorted(f for f in os.listdir(video_path)
                        if f.lower().endswith(FRAME_EXTS))
        return {"n_frames": len(frames)}

    def add_new_mask(self, inference_state, frame_idx, obj_id, mask):
        self.calls.append(("add_new_mask", frame_idx, obj_id,
                           str(mask.device), mask.cpu().numpy()))
        self.objects.append(obj_id)

    def propagate_in_video(self, state):
        h = w = self.image_size
        for f in range(state["n_frames"]):
            rng = np.random.default_rng(100 + f)
            logits = rng.normal(size=(len(self.objects), 1, h, w))
            yield f, list(self.objects), torch.from_numpy(
                logits.astype(np.float32)).to(self.device)


def modules(calls: list) -> dict:
    """The ``sys.modules`` entries of the stand-in, recording into
    ``calls``."""

    def build_sam2(cfg, ckpt, device="cuda", apply_postprocessing=True):
        calls.append(("build_sam2", cfg, ckpt, str(device),
                      apply_postprocessing))
        return types.SimpleNamespace(device=str(device))

    def build_sam2_video_predictor(cfg, ckpt, device="cuda"):
        calls.append(("build_sam2_video_predictor", cfg, ckpt, str(device)))
        return _Predictor(calls, device)

    root = types.ModuleType("sam2")
    gen = types.ModuleType("sam2.automatic_mask_generator")
    gen.SAM2AutomaticMaskGenerator = \
        lambda *a, **kw: _Generator(calls, *a, **kw)
    build = types.ModuleType("sam2.build_sam")
    build.build_sam2 = build_sam2
    build.build_sam2_video_predictor = build_sam2_video_predictor
    root.automatic_mask_generator, root.build_sam = gen, build
    return {"sam2": root, "sam2.automatic_mask_generator": gen,
            "sam2.build_sam": build}
