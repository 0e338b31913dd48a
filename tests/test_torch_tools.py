"""rain_tpu_torch.tools against rain_tpu.tools, on the CPU.

Every tool of rain_tpu/tools runs in both packages on the same inputs,
made from a seed with numpy, and the outputs are compared bit for bit:
images pixel by pixel, the VLM requests message by message, the SAM2
tools' file trees file by file. No JAX code runs here (rain_tpu's tools
import numpy, PIL, torch and their optional packages only).

- combine_masks: both CLIs on two 40x32 frames whose masks cover an
  8-bit grey PNG, an RGB PNG (PIL's luma), an empty mask and a missing
  one; ``blend`` against rain_tpu's arithmetic at every mask value.
- vlm/annotate_axes: ``build_overlay`` at several sizes, ``run`` and
  ``main`` on a folder with non-image files.
- vlm/*: the data URLs; each CLI with a recording fake client in place
  of ``make_client`` (the request, stdout and written files, the error
  path where the tool has one); both ``make_client`` without ``openai``.
- SAM2: ``overlay_image``; both CLIs with a stand-in ``sam2``
  (tests/torch_sam2_stub.py), both modes of the image tool, the video
  tool with and without cv2; both without ``sam2``.
"""

import base64
import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_sam2_stub as sam2_stub
from rain_tpu.tools import combine_masks as combine_jax
from rain_tpu.tools import sam2_image_masks as sam2_image_jax
from rain_tpu.tools import sam2_video_masks as sam2_video_jax
from rain_tpu.tools.vlm import annotate_axes as axes_jax
from rain_tpu.tools.vlm import common as common_jax
from rain_tpu.tools.vlm import image_symmetry as symmetry_jax
from rain_tpu.tools.vlm import parts as parts_jax
from rain_tpu.tools.vlm import rotation as rotation_jax
from rain_tpu.tools.vlm import rotation_table as rotation_table_jax
from rain_tpu.tools.vlm import size as size_jax
from rain_tpu_torch.data import images
from rain_tpu_torch.tools import combine_masks as combine_port
from rain_tpu_torch.tools import sam2_image_masks as sam2_image_port
from rain_tpu_torch.tools import sam2_video_masks as sam2_video_port
from rain_tpu_torch.tools.vlm import annotate_axes as axes_port
from rain_tpu_torch.tools.vlm import common as common_port
from rain_tpu_torch.tools.vlm import image_symmetry as symmetry_port
from rain_tpu_torch.tools.vlm import parts as parts_port
from rain_tpu_torch.tools.vlm import rotation as rotation_port
from rain_tpu_torch.tools.vlm import rotation_table as rotation_table_port
from rain_tpu_torch.tools.vlm import size as size_port

torch.set_num_threads(1)

W, H = 40, 32


def _run(main, argv):
    """(return value, stdout) of ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


def _pixels(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def _same_tree(a: Path, b: Path):
    """The same files under ``a`` and ``b``; images pixel for pixel, the
    rest byte for byte."""
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        pa, pb = a / rel, b / rel
        if pa.is_dir():
            continue
        if pa.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp", ".tiff"):
            ma, xa = _pixels(pa)
            mb, xb = _pixels(pb)
            assert ma == mb, rel
            np.testing.assert_array_equal(xa, xb, err_msg=rel)
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel


def _save(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


# --- combine_masks ------------------------------------------------------

def _rain_tpu_blend(base, masks, alpha):
    """rain_tpu/tools/combine_masks.py:48-59 on arrays (None: missing)."""
    final = base.copy()
    for mask, color in zip(masks, combine_jax.DEFAULT_COLORS.values()):
        if mask is None:
            continue
        if not (mask > 0).any():
            continue
        color_img = (mask[..., None] / 255.0) * np.array(color, np.float32)
        a = (mask / 255.0 * alpha)[..., None]
        final = (1 - a) * final + a * color_img
    return final


def _mask_scene(root: Path, seed=0):
    """Two frames of 40x32 with their base renders and masks: an 8-bit
    grey PNG, an RGB PNG, an empty mask and a missing one, in another
    order per frame; a stray file beside the frame directories."""
    rng = np.random.default_rng(seed)
    layouts = {"frame_a": ("grey", "empty", None, "rgb"),
               "frame_b": ("rgb", "grey", "empty", None)}
    for frame, kinds in layouts.items():
        _save(root / "base" / f"{frame}.png",
              rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        (root / "masks" / frame).mkdir(parents=True)
        for name, kind in zip(combine_jax.DEFAULT_COLORS, kinds):
            grey = rng.integers(0, 256, (H, W), dtype=np.uint8)
            grey[rng.random((H, W)) < 0.3] = 0
            path = root / "masks" / frame / name
            if kind == "grey":
                images.save_png(path, grey)
            elif kind == "empty":
                images.save_png(path, np.zeros((H, W), np.uint8))
            elif kind == "rgb":
                _save(path, rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    (root / "masks" / "notes.txt").write_text("not a frame")
    return list(layouts)


@pytest.mark.parametrize("alpha", [None, 0.3])
def test_combine_masks_cli_matches_rain_tpu(tmp_path, alpha):
    frames = _mask_scene(tmp_path)
    argv = ["--masks", str(tmp_path / "masks"), "--base",
            str(tmp_path / "base")]
    if alpha is not None:
        argv += ["--alpha", str(alpha)]
    _, said_jax = _run(combine_jax.main,
                       argv + ["--out", str(tmp_path / "jax")])
    rec, said_port = _run(combine_port.main, argv + [
        "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert rec == {"device": "cpu", "overlays": 2}
    assert said_port.replace("port", "jax") == said_jax
    assert said_jax == f"wrote 2 overlays to {tmp_path / 'jax'}\n"
    assert _tree(tmp_path / "port") == [f"{f}.png" for f in frames]
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_combine_masks_reads_masks_as_rain_tpu(tmp_path):
    """An RGB mask through PIL's luma, a grey one through numpy: both as
    rain_tpu's ``Image.open(mp).convert("L")``."""
    _mask_scene(tmp_path)
    for path in sorted((tmp_path / "masks").rglob("00*.png")):
        with Image.open(path) as im:
            want = np.asarray(im.convert("L"))
        np.testing.assert_array_equal(images.load_grey(path), want)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 1.0])
def test_blend_matches_rain_tpu_at_every_mask_value(alpha):
    """Each of the four masks takes every value 0-255 (a permutation per
    mask); a fifth case has an empty and an all-255 mask."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (16, 256, 3)).astype(np.float32)
    masks = [np.stack([rng.permutation(256) for _ in range(16)]).astype(
        np.float32) for _ in range(4)]
    # the values where a product by 1/255 rounds apart from the division
    assert (masks[0] * np.float32(1 / 255.0) != masks[0] / 255.0).any()
    cases = [masks, [masks[0], np.zeros_like(masks[0]),
                     np.full_like(masks[0], 255.0), None]]
    for ms in cases:
        want = _rain_tpu_blend(base, ms, alpha)
        got = combine_port.blend(
            torch.from_numpy(base),
            [None if m is None else torch.from_numpy(m) for m in ms],
            alpha).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


# --- vlm/annotate_axes --------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (7, 5), (40, 32), (641, 479),
                                  (1297, 840)])
def test_build_overlay_matches_rain_tpu(size):
    assert axes_port.build_overlay(size) == axes_jax.build_overlay(size)


def test_annotate_axes_matches_rain_tpu(tmp_path):
    rng = np.random.default_rng(2)
    src = tmp_path / "in"
    for name, shape in (("a.png", (32, 40, 3)), ("b.JPG", (33, 41, 3)),
                        ("c.bmp", (17, 9, 3)), ("d.gif", (25, 31))):
        _save(src / name, rng.integers(0, 256, shape, dtype=np.uint8))
    (src / "notes.txt").write_text("skipped")
    (src / "e.npy").write_bytes(b"skipped")
    count_jax, said_jax = _run(lambda a: axes_jax.run(*a),
                               (str(src), str(tmp_path / "jax")))
    count_port, said_port = _run(lambda a: axes_port.run(*a),
                                 (str(src), str(tmp_path / "port")))
    assert count_port == count_jax == 4
    assert said_port == said_jax
    _same_tree(tmp_path / "jax", tmp_path / "port")
    outs = {}
    for pkg, mod in (("jax", axes_jax), ("port", axes_port)):
        outs[pkg] = _run(mod.main, ["--input_folder", str(src),
                                    "--output_folder",
                                    str(tmp_path / f"main_{pkg}")])[1]
    assert outs["port"] == outs["jax"]
    assert outs["jax"].endswith("All images processed successfully.\n")
    _same_tree(tmp_path / "main_jax", tmp_path / "main_port")


# --- vlm ----------------------------------------------------------------

class FakeClient:
    """Records each chat-completion request; answers or raises."""

    def __init__(self, error=None):
        self.requests, self.error = [], error
        self.chat = self
        self.completions = self

    def create(self, **kwargs):
        self.requests.append(kwargs)
        if self.error is not None:
            raise self.error
        n = len(self.requests)
        return type("R", (), {"choices": [type("C", (), {
            "message": type("M", (), {"content": f"answer {n}"})})]})


VLM = {"image_symmetry": (symmetry_jax, symmetry_port),
       "parts": (parts_jax, parts_port),
       "rotation": (rotation_jax, rotation_port),
       "rotation_table": (rotation_table_jax, rotation_table_port),
       "size": (size_jax, size_port)}


def _vlm_inputs(root: Path, n_views=2):
    rng = np.random.default_rng(3)
    for k in range(6):
        _save(root / "img" / f"{k}.png",
              rng.integers(0, 256, (8, 12, 3), dtype=np.uint8))
    _save(root / "img" / "photo.jpg",
          rng.integers(0, 256, (8, 12, 3), dtype=np.uint8))
    views = root / "views"
    for k in range(n_views):
        _save(views / f"v{k}.png",
              rng.integers(0, 256, (8, 12, 3), dtype=np.uint8))
    (views / "readme.txt").write_text("not an image")
    img = [str(root / "img" / f"{k}.png") for k in range(6)]
    return {
        "image_symmetry": ["--input_folder", str(views), "--output_folder",
                           str(root / "OUT")],
        "parts": ["--photo", str(root / "img" / "photo.jpg"), "--masks",
                  img[0]],
        "rotation": ["--input_image", img[4], "--exemplars", *img[:4]],
        "rotation_table": ["--input_image", img[5], "--exemplars",
                           *img[:4]],
        "size": ["--image_path", img[1]],
    }


def _vlm_run(mod, argv, monkeypatch, error=None):
    """(requests sent, api keys, stdout, the error raised) of ``mod``'s
    CLI with a fake client that answers, or raises ``error``."""
    client, keys = FakeClient(error), []

    def make_client(api_key):
        keys.append(api_key)
        return client

    monkeypatch.setattr(mod, "make_client", make_client)
    buf, raised = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            mod.main(argv + ["--api_key", "sk-test"])
        except RuntimeError as e:
            raised = str(e)
    return client.requests, keys, buf.getvalue(), raised


# the tools that report a failed request; the others raise it
REPORTS_ERRORS = ("image_symmetry", "size")


@pytest.mark.parametrize("tool", list(VLM))
@pytest.mark.parametrize("error", [None, "quota exceeded"])
def test_vlm_cli_request_matches_rain_tpu(tool, error, tmp_path,
                                          monkeypatch):
    argv = _vlm_inputs(tmp_path)[tool]
    result = tmp_path / "OUT" / "symmetry_analysis_result.txt"
    runs = {}
    for pkg, mod in zip(("jax", "port"), VLM[tool]):
        runs[pkg] = _vlm_run(mod, argv, monkeypatch,
                             RuntimeError(error) if error else None)
        if result.exists():
            runs[pkg] += (result.read_text(),)
            result.unlink()
    assert runs["port"] == runs["jax"]
    requests, keys, said, raised = runs["jax"][:4]
    assert keys == ["sk-test"] and len(requests) == 1
    if error is None:
        assert raised is None and "answer 1" in said
    elif tool in REPORTS_ERRORS:
        assert raised is None and f"An error occurred: {error}" in said
    else:
        assert raised == error
    assert (len(runs["jax"]) == 5) == (tool == "image_symmetry")


def test_image_symmetry_wants_two_images(tmp_path, monkeypatch):
    argv = ["--input_folder", str(tmp_path / "views"), "--output_folder",
            str(tmp_path / "OUT")]
    _vlm_inputs(tmp_path, n_views=3)
    runs = [_vlm_run(mod, argv, monkeypatch) for mod in VLM["image_symmetry"]]
    assert runs[1] == runs[0] == (
        [], [], "Error: Expected 2 images in the input folder, but found "
        "3.\n", None)
    assert not (tmp_path / "OUT").exists()


def test_vlm_defaults_and_prompts_match_rain_tpu():
    assert rotation_port.DEFAULT_EXEMPLARS == rotation_jax.DEFAULT_EXEMPLARS
    assert rotation_table_port.DEFAULT_EXEMPLARS == \
        rotation_table_jax.DEFAULT_EXEMPLARS
    assert symmetry_port.SYS_PROMPT == symmetry_jax.SYS_PROMPT
    assert symmetry_port.EXTS == symmetry_jax.EXTS
    assert size_port.SYS_PROMPT == size_jax.SYS_PROMPT


@pytest.mark.parametrize("name", ["a.png", "b.jpg", "c.JPG", "noext"])
def test_image_data_url_matches_rain_tpu(name, tmp_path):
    path = tmp_path / name
    path.write_bytes(bytes(range(256)) * 3)
    url = common_port.image_data_url(path)
    assert url == common_jax.image_data_url(path)
    head, data = url.split(",")
    assert base64.b64decode(data) == path.read_bytes()
    assert head == "data:image/{};base64".format(
        {"a.png": "png", "b.jpg": "jpeg", "c.JPG": "jpeg",
         "noext": "png"}[name])


def test_ask_with_images_matches_rain_tpu(tmp_path):
    paths = [tmp_path / "x.png", tmp_path / "y.jpeg"]
    for k, p in enumerate(paths):
        p.write_bytes(bytes([k]) * 40)
    sent = {}
    for pkg, mod in (("jax", common_jax), ("port", common_port)):
        client = FakeClient()
        answers = [mod.ask_with_images(client, "q", paths),
                   mod.ask_with_images(client, "", paths[:1], system="s",
                                       model="m", max_tokens=7)]
        sent[pkg] = (client.requests, answers)
    assert sent["port"] == sent["jax"]
    assert sent["jax"][0][1] == {"model": "m", "max_tokens": 7, "messages": [
        {"role": "system", "content": "s"},
        {"role": "user", "content": [{"type": "image_url", "image_url": {
            "url": common_jax.image_data_url(paths[0])}}]}]}


def test_make_client_without_openai(monkeypatch):
    monkeypatch.setitem(sys.modules, "openai", None)
    exits = []
    for mod in (common_jax, common_port):
        with pytest.raises(SystemExit) as e:
            mod.make_client("k")
        exits.append(e.value.code)
    assert exits[1] == exits[0]
    assert exits[0].startswith("openai is not installed (")


# --- SAM2 ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 40), (17, 9), (1, 1)])
def test_overlay_image_matches_rain_tpu(shape):
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    masks = sam2_stub._masks(image) if min(shape) > 1 else [
        {"segmentation": np.ones(shape, bool), "area": 1}] * 2
    got = sam2_image_port.overlay_image(masks, shape)
    want = sam2_image_jax.overlay_image(masks, shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _sam2_frames(root: Path, names):
    rng = np.random.default_rng(5)
    for k, name in enumerate(names):
        if name.endswith(".txt"):
            (root / name).write_text("skipped")
            continue
        _save(root / name, rng.integers(0, 256, (H + k, W, 3),
                                        dtype=np.uint8))
    return root


def _sam2_run(main, argv, monkeypatch):
    """(the stand-in's calls, stdout) of ``main(argv)``."""
    calls = []
    for name, module in sam2_stub.modules(calls).items():
        monkeypatch.setitem(sys.modules, name, module)
    _, said = _run(main, argv)
    return calls, said


def _same_calls(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert len(ca) == len(cb) and ca[0] == cb[0]
        for x, y in zip(ca, cb):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x.view(np.uint8),
                                              y.view(np.uint8))
            else:
                assert x == y


@pytest.mark.parametrize("mode,every", [("overlay", 1), ("overlay", 2),
                                        ("binary", 1), ("binary", 3)])
def test_sam2_image_masks_matches_rain_tpu(mode, every, tmp_path,
                                           monkeypatch):
    names = ["a.png", "B.PNG", "c.bmp", "d.tiff", "e.txt", "f.png"]
    if mode == "binary":
        names += ["g.jpg", "h.jpeg"]
    src = _sam2_frames(tmp_path / "in", names)
    argv = ["-i", str(src), "--mode", mode, "--every", str(every),
            "--min_area", "10", "--checkpoint", "w.pt"]
    jax_run = _sam2_run(sam2_image_jax.main,
                        argv + ["-o", str(tmp_path / "jax"),
                                "--device", "cpu"], monkeypatch)
    port_run = _sam2_run(sam2_image_port.main,
                         argv + ["-o", str(tmp_path / "port"),
                                 "--device", "cpu"], monkeypatch)
    _same_calls(jax_run[0], port_run[0])
    assert port_run[1] == jax_run[1]
    assert jax_run[0][0] == ("build_sam2", "configs/sam2.1/sam2.1_hiera_l"
                             ".yaml", "w.pt", "cpu", False)
    _same_tree(tmp_path / "jax", tmp_path / "port")
    kept = sorted(n for n in names if not n.endswith(".txt"))[::every]
    assert port_run[1].splitlines() == [str(src / n) for n in kept]
    if mode == "binary":
        assert len(_tree(tmp_path / "port")) == len(kept) * (
            1 + sam2_stub.N_MASKS)


def test_sam2_image_overlay_of_a_jpeg(tmp_path, monkeypatch):
    """rain_tpu cannot save the RGBA overlay of a JPEG input under its
    name; the port writes it as <stem>.png."""
    src = _sam2_frames(tmp_path / "in", ["x.jpg"])
    argv = ["-i", str(src), "--device", "cpu"]
    with pytest.raises(OSError, match="RGBA"):
        _sam2_run(sam2_image_jax.main, argv + ["-o", str(tmp_path / "j")],
                  monkeypatch)
    _sam2_run(sam2_image_port.main, argv + ["-o", str(tmp_path / "p")],
              monkeypatch)
    assert _tree(tmp_path / "p") == ["x.png"]
    with Image.open(src / "x.jpg") as im:
        image = np.asarray(im.convert("RGB"))
    want = (sam2_image_jax.overlay_image(sam2_stub._masks(image),
                                         image.shape[:2]) * 255).astype(
        np.uint8)
    assert _pixels(tmp_path / "p" / "x.png")[0] == "RGBA"
    np.testing.assert_array_equal(_pixels(tmp_path / "p" / "x.png")[1], want)


@pytest.mark.parametrize("cv2", [True, False])
def test_sam2_video_masks_matches_rain_tpu(cv2, tmp_path, monkeypatch):
    if not cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    src = _sam2_frames(tmp_path / "in", ["0.png", "1.jpg", "2.png",
                                         "10.png", "notes.txt"])
    runs = {}
    for pkg, mod in (("jax", sam2_video_jax), ("port", sam2_video_port)):
        runs[pkg] = _sam2_run(mod.main, [
            "--video_path", str(src), "--out",
            str(tmp_path / pkg / "masks"), "--checkpoint", "w.pt",
            "--device", "cpu"], monkeypatch)
    _same_calls(runs["jax"][0], runs["port"][0])
    said = runs["jax"][1]
    assert runs["port"][1].replace(str(tmp_path / "port"),
                                   str(tmp_path / "jax")) == said
    assert said.startswith(f"Number of auto-masks: {sam2_stub.N_MASKS}\n")
    assert ("cv2 not available; skipping mp4" in said) == (not cv2)
    prompts = [c for c in runs["port"][0] if c[0] == "add_new_mask"]
    assert [c[2] for c in prompts] == list(range(sam2_stub.N_MASKS))
    assert prompts[0][4].shape == (sam2_stub.IMAGE_SIZE // 4,) * 2
    _same_tree(tmp_path / "jax", tmp_path / "port")
    tree = _tree(tmp_path / "port" / "masks")
    assert tree.count("frame_0003/all.jpg") == 1
    assert ("masks.mp4" in tree) == cv2


@pytest.mark.parametrize("tool", ["image", "video"])
def test_sam2_tools_without_sam2(tool, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sam2", None)
    mods = {"image": (sam2_image_jax, sam2_image_port),
            "video": (sam2_video_jax, sam2_video_port)}[tool]
    argv = {"image": ["-i", str(tmp_path), "-o", str(tmp_path / "o")],
            "video": ["--video_path", str(tmp_path), "--out",
                      str(tmp_path / "o"), "--checkpoint", "w.pt"]}[tool]
    exits = []
    for mod in mods:
        with pytest.raises(SystemExit) as e:
            mod.main(argv + ["--device", "cpu"])
        exits.append(e.value.code)
    assert exits[1] == exits[0]
    assert exits[0].startswith("sam2 is not installed (")
    assert not (tmp_path / "o").exists()
