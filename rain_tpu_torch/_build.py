"""Kernel loader: nvcc over ``csrc/*.cu`` at first use, bound with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``),
all nvcc processes started together. Libraries land in
``rain_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the build.
Importing the package never needs nvcc: nothing here runs until a kernel
is launched on a CUDA tensor.

``-fmad=false`` keeps nvcc from contracting a*b+c into one rounding, so a
kernel rounds like its plain PyTorch version, whose element-wise ops round
one at a time. No ``--use_fast_math``: ``expf`` stays the accurate one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)"
                       "; the CUDA kernels build from source at first use")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` whose library is missing.

    Returns {source stem: nvcc output} for the sources built by this call
    (ptxas's registers, shared memory and spills per kernel). Raises
    RuntimeError if nvcc fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    todo = [(src.stem, src, _library_path(src))
            for src in sorted(CSRC.glob("*.cu"))]
    todo = [job for job in todo if not job[2].exists()]
    logs = {}
    if todo:
        nvcc = _nvcc()
        procs = []
        for name, src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs.append((name, src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, src, out, tmp, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            logs[name] = log
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(_library_path(CSRC / f"{name}.cu")))


@functools.cache
def kernel(lib: str, fn: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of ``csrc/<lib>.cu``, built on first use.

    Every entry takes (device index, stream, *argtypes) and returns a
    cudaError_t; pass pointers as ``ctypes.c_void_p``."""
    f = getattr(_library(lib), fn)
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, *argtypes]
    f.restype = ctypes.c_int
    return f


def launch(f, device: torch.device, *args) -> None:
    """Call entry ``f`` on ``device``'s current stream; raise on an error."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = f(index, stream, *args)
    if err != 0:
        raise RuntimeError(f"{f.__name__} failed with cudaError_t {err}")
