"""Build and load the package's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface. It is compiled
at first use by ``nvcc`` into a shared library, keyed by a hash of the
source, of every header it includes (``LIBRARIES``) and of the flags, and
loaded with ``ctypes``. In a checkout (``pyproject.toml`` beside the
package, in a directory it may write) the library goes to
``build/flux_tpu_torch/`` there; an installed package builds into the user's
cache, ``~/.cache/flux_tpu_torch/``. Nothing is built when a module is
imported; only a launch on a CUDA tensor builds. :func:`build_many` compiles several sources at once, one
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
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "LIBRARIES", "build", "build_many", "load", "BUILD_LOG", "LAUNCH_LOCK", "SentRecords",
           "SENT"]

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

# Held by a wrapper around its upload of the library's __constant__ records
# (SENT), its launch and its launch count; two threads' calls (two renderers
# of one process, say a local worker and a node's) must not interleave
# between the check of what the records hold and the launch that reads them.
LAUNCH_LOCK = threading.Lock()


class SentRecords:
    """What each kernel library's ``__constant__`` records hold on each
    device, and the launches that may still read them, so that a wrapper
    uploads a record only where it changed and never under a kernel that
    reads it. Launches of one library may run on several streams at once
    (``Renderer.queue_rows`` takes two in turn). ``new_event`` makes the
    events it records (``torch.cuda.Event`` by default). Use it under
    ``LAUNCH_LOCK``."""

    def __init__(self, new_event=None):
        self._new_event = new_event
        # (library handle, device index) -> {"records": {name: bytes},
        # "uploaded": (stream handle, event) of the last upload still to be
        # waited on, "in_flight": {stream handle: event behind its last launch}}
        self._by_key: dict = {}

    def _event(self):
        if self._new_event is None:
            import torch

            return torch.cuda.Event()
        return self._new_event()

    def _state(self, lib, device: int) -> dict:
        key = (lib._handle, device)
        if key not in self._by_key:
            self._by_key[key] = {"records": {}, "uploaded": None, "in_flight": {}}
        return self._by_key[key]

    def send(self, lib, device: int, stream, records: dict, upload) -> bool:
        """Queue on ``stream`` the upload of those of ``records`` (symbol
        name -> packed bytes) that ``lib``'s ``__constant__`` memory on
        ``device`` does not hold, through ``upload(names)``, which returns a
        CUDA error (a RuntimeError here where it is not 0); True where
        anything was sent. Before it overwrites a record, ``stream`` waits on
        each other stream's last launch of the library (:meth:`launched`)
        still running. Where nothing is sent, ``stream`` waits on the last
        upload where that was queued on another stream and has not ended, so
        that no launch reads a record before it arrives."""
        st = self._state(lib, device)
        here = stream.cuda_stream
        changed = [name for name, data in records.items() if st["records"].get(name) != data]
        if not changed:
            if st["uploaded"] is not None:
                on, ev = st["uploaded"]
                if ev.query():
                    st["uploaded"] = None
                elif on != here:
                    stream.wait_event(ev)
            return False
        for on, ev in st["in_flight"].items():
            if on != here and not ev.query():
                stream.wait_event(ev)
        err = upload(changed)
        if err != 0:
            for name in changed:  # what the device holds now is not known
                st["records"].pop(name, None)
            raise RuntimeError(f"__constant__ upload of {changed} failed: CUDA error {err}")
        st["records"].update((name, records[name]) for name in changed)
        ev = self._event()
        ev.record(stream)
        st["uploaded"] = (here, ev)
        return True

    def launched(self, lib, device: int, stream) -> None:
        """Note a launch of ``lib`` on ``device`` just queued on ``stream``:
        an upload on another stream waits for it to end."""
        st = self._state(lib, device)
        ev = self._event()
        ev.record(stream)
        st["in_flight"] = {on: e for on, e in st["in_flight"].items() if not e.query()}
        st["in_flight"][stream.cuda_stream] = ev


# The process's record of what the kernel libraries' __constant__ memory
# holds (each library is loaded once, in load(), and its records are written
# by the wrappers alone).
SENT = SentRecords()


def _build_dir() -> Path:
    root = CSRC.parent.parent
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / "flux_tpu_torch"
    return Path.home() / ".cache" / "flux_tpu_torch"


BUILD_DIR = _build_dir()


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
    "scene_megakernel": ("flux_trace.cuh", "scan_walk.cuh", "scene_geom.cuh"),
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
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""})
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
