"""The native COLMAP parsers (colmap_fast.c), built with cc and bound with
ctypes.

Host I/O, not a device kernel. Port of rain_tpu/native/__init__.py with
one difference: rain_tpu drops to its Python parser on any failure
(rain_tpu/data/colmap.py:25-30), so a broken build goes unnoticed. Here
the library is built at first use with ``cc -O2 -shared -fPIC`` into
``rain_tpu_torch/_build/`` under a name keyed by a hash of the source (as
``_build`` builds the kernels), the choice of parser is logged once, and:

- with no C compiler on PATH, ``load()`` returns None and the Python
  parser of ``rain_tpu_torch.data.colmap`` is used;
- with a compiler whose build fails, ``load()`` raises with its output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).with_name("colmap_fast.c")
BUILD_DIR = Path(__file__).parents[1] / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "clang")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"colmap_fast_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str | None:
    """Compile SOURCE to ``out``; the compiler's path, or None if there is
    none on PATH. Raises RuntimeError with its output if the build fails."""
    cc = next(filter(None, map(shutil.which, COMPILERS)), None)
    if cc is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return cc


@functools.cache
def load() -> ctypes.CDLL | None:
    """The colmap_fast library, built on first use; None when no C
    compiler is on PATH. Prints once which parser the COLMAP reader
    takes."""
    so = library_path()
    if not so.exists() and _build(so) is None:
        print(f"[colmap] no C compiler ({', '.join(COMPILERS)}) on PATH: "
              f"parsing COLMAP binaries with the Python parser")
        return None
    lib = ctypes.CDLL(str(so))
    lib.colmap_parse_points3d.restype = ctypes.c_long
    lib.colmap_parse_points3d.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long]
    lib.colmap_parse_images.restype = ctypes.c_long
    lib.colmap_parse_images.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    print(f"[colmap] parsing COLMAP binaries with the native parser "
          f"({so.name})")
    return lib
