"""Build and load the package's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface. It is compiled
at first use by ``nvcc`` into a shared library, keyed by a hash of the
source, of every header it includes (``LIBRARIES``) and of the flags, and
loaded with ``ctypes``. The library goes to ``build/flux_tpu_torch/`` beside
the package. Nothing is built when a module is imported; only a launch on a
CUDA tensor builds. :func:`build_many` compiles several sources at once, one
``nvcc`` process each, all started together.

The flags target Hopper (``sm_90a``) and keep IEEE float semantics: no fast
math, no flush-to-zero, correctly rounded division and square root (the
kernels rely on NaN and inf comparisons and on bit-exact sample points), and
no contraction of a multiply and an add into one FMA, so the kernel's
arithmetic follows its plain PyTorch version op by op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "LIBRARIES", "build", "build_many", "load", "BUILD_LOG"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": the compiler's register and memory report}
BUILD_LOG: dict = {}
_LOADED: dict = {}


BUILD_DIR = CSRC.parent.parent / "build" / "flux_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put nvcc on PATH or set CUDA_HOME")


# Library name (csrc/<name>.cu) -> the headers under csrc/ it is compiled
# from, which the cache key covers beside the source itself.
LIBRARIES = {
    "sweep_megakernel": ("flux_trace.cuh",),
    "scene_megakernel": ("flux_trace.cuh",),
}


def _plan(name: str):
    """(source, library path) of ``csrc/<name>.cu``; the library's name
    carries a hash of every file it is compiled from and of the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *(CSRC / h for h in LIBRARIES[name])):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_many(names) -> list:
    """Compile each ``csrc/<name>.cu`` that has no library of the same
    sources and flags yet, one nvcc process each, started together; returns
    the libraries' paths. ``BUILD_LOG[name]`` keeps each library's build
    seconds and compiler report."""
    running, libs = [], []
    for name in names:
        src, lib = _plan(name)
        libs.append(lib)
        log = lib.with_suffix(".log")
        if lib.exists():
            BUILD_LOG[name] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, src, lib, log, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, lib, log, tmp, proc, t0 in running:
        report = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name}:\n{report}")
            continue
        log.write_text(report)
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": report}
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags exists; returns the library's path."""
    return build_many([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
