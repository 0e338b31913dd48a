"""The port's COLMAP parsers (rain_tpu_torch/data/colmap.py and the native
rain_tpu_torch/native/colmap_fast.c) against rain_tpu's.

Binary and text, native and Python, on tests/test_colmap.py's sparse model
(track and 2D-point lists of random lengths) and on tests/test_cli_e2e.py's
scene. Tolerance: none; every field of every record is equal bit for bit
(float64 arrays compared by their bits, ids and names exactly). Neither
package keeps the images' 2D points or point3D ids, so there are none to
compare. Then what the port does where rain_tpu drops silently to Python:
a truncated file raises, a missing compiler is logged, a failed build
raises with the compiler's output.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rain_tpu.data import colmap as colmap_jax
from rain_tpu_torch import native
from rain_tpu_torch.data import colmap as colmap_port
from test_cli_e2e import _binary_to_text_sparse, _write_colmap_scene
from test_colmap import synthetic_sparse  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _same(a, b):
    """Equal bit for bit: arrays by dtype, shape and bytes, the rest by ==."""
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape and
                a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def _same_records(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]).__name__ == type(want[k]).__name__
        for f in dataclasses.fields(want[k]):
            assert _same(getattr(got[k], f.name), getattr(want[k], f.name)), \
                (k, f.name)


def _same_points(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap_scene")
    _write_colmap_scene(root, np.random.default_rng(7))
    text = tmp_path_factory.mktemp("colmap_text") / "sparse" / "0"
    _binary_to_text_sparse(root, text)
    return root / "sparse" / "0", text


def test_port_takes_the_native_parser():
    assert native.load() is not None
    assert colmap_port.parser() == "native"


def test_points3d_binary(synthetic_sparse):  # noqa: F811
    path = synthetic_sparse[0] / "points3D.bin"
    want = colmap_jax._read_points3d_binary_py(path)
    _same_points(colmap_port.read_points3d_binary(path), want)   # native
    _same_points(colmap_port._read_points3d_binary_py(path), want)
    _same_points(colmap_port.read_points3d_binary(path),
                 colmap_jax.read_points3d_binary(path))


def test_images_binary(synthetic_sparse):  # noqa: F811
    path = synthetic_sparse[0] / "images.bin"
    want = colmap_jax._read_images_binary_py(path)
    _same_records(colmap_port.read_images_binary(path), want)    # native
    _same_records(colmap_port._read_images_binary_py(path), want)
    _same_records(colmap_port.read_images_binary(path),
                  colmap_jax.read_images_binary(path))


def test_cli_scene_binary_and_text(scene):
    binary, text = scene
    _same_records(colmap_port.read_cameras_binary(binary / "cameras.bin"),
                  colmap_jax.read_cameras_binary(binary / "cameras.bin"))
    _same_records(colmap_port.read_cameras_text(text / "cameras.txt"),
                  colmap_jax.read_cameras_text(text / "cameras.txt"))
    _same_records(colmap_port.read_images_text(text / "images.txt"),
                  colmap_jax.read_images_text(text / "images.txt"))
    _same_points(colmap_port.read_points3d_text(text / "points3D.txt"),
                 colmap_jax.read_points3d_text(text / "points3D.txt"))
    _same_points(colmap_port.read_points3d_binary(binary / "points3D.bin"),
                 colmap_jax._read_points3d_binary_py(binary /
                                                     "points3D.bin"))
    for d in (binary, text):
        got, want = colmap_port.load_sparse(d), colmap_jax.load_sparse(d)
        _same_records(got[0], want[0])
        _same_records(got[1], want[1])


def test_qvec2rotmat():
    rng = np.random.default_rng(3)
    for q in rng.normal(size=(20, 4)):
        assert _same(colmap_port.qvec2rotmat(q), colmap_jax.qvec2rotmat(q))


@pytest.mark.parametrize("name", ["points3D.bin", "images.bin"])
def test_truncated_file_raises(synthetic_sparse, tmp_path, name):  # noqa: F811
    data = (synthetic_sparse[0] / name).read_bytes()
    for cut in (5, 30, len(data) - 3):
        path = tmp_path / name
        path.write_bytes(data[:cut])
        read = colmap_port.read_points3d_binary if name == "points3D.bin" \
            else colmap_port.read_images_binary
        with pytest.raises(ValueError, match=name):
            read(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(ValueError, match="nothing.bin"):
        colmap_port.read_points3d_binary(tmp_path / "nothing.bin")


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """native.load() from an empty build directory; its cache cleared
    before and after."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.load.cache_clear()
    yield
    native.load.cache_clear()


def test_no_compiler_falls_back_to_python_and_says_so(
        fresh_native, monkeypatch, capsys, synthetic_sparse):  # noqa: F811
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.load() is None
    assert colmap_port.parser() == "python"
    out = capsys.readouterr().out
    assert out.count("[colmap]") == 1 and "Python parser" in out
    path = synthetic_sparse[0] / "points3D.bin"
    _same_points(colmap_port.read_points3d_binary(path),
                 colmap_jax._read_points3d_binary_py(path))


def test_failed_build_raises_with_the_compiler_output(
        fresh_native, monkeypatch, tmp_path):
    bad = tmp_path / "colmap_fast.c"
    bad.write_text("long colmap_parse_points3d( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="(?s)failed to build.*error"):
        native.load()


def test_build_is_keyed_by_the_source(fresh_native, capsys):
    lib = native.load()
    assert lib is not None and native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert "native parser" in capsys.readouterr().out
    assert lib.colmap_parse_points3d(b"/nonexistent", None, None, None,
                                     0) == -1
