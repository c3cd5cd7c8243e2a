"""ctypes loader of the native host code, ``csrc/fluxnative.cpp``
(``flux_tpu/native.py``).

The library holds the P3 encoder behind :func:`flux_tpu_torch.image.ppm_bytes`,
the same truncating quantization to uint16 (``flux_quantize_u16``), and the
scheduler core of :mod:`flux_tpu_torch.sched`, which declares the
``flux_sched_*`` signatures itself. It is built with ``g++ -O3 -fPIC
-shared`` at first use, into the directory the CUDA kernels are built in
(``ops/build.py``'s ``BUILD_DIR``), under a name keyed by a hash of the
source and the flags. Where there is no compiler, the callers fall back to
Python: the native path is an accelerator, never a requirement.
``load_error`` says why a load failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .ops.build import BUILD_DIR, CSRC

__all__ = ["get_lib", "ppm_encode_native", "available", "library_path", "CXX_FLAGS"]

CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
SOURCE = CSRC / "fluxnative.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libfluxnative-{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be."""
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            load_error = f"{type(e).__name__}: {e} {detail}".strip()
            return None
        lib.flux_ppm_bound.restype = ctypes.c_size_t
        lib.flux_ppm_bound.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.flux_ppm_encode.restype = ctypes.c_size_t
        lib.flux_ppm_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
        ]
        lib.flux_quantize_u16.restype = None
        lib.flux_quantize_u16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def ppm_encode_native(pixels: np.ndarray) -> Optional[bytes]:
    """Encode (H, W, 3) float32 pixels to P3 bytes, or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels, np.float32)
    h, w = px.shape[:2]
    buf = ctypes.create_string_buffer(lib.flux_ppm_bound(h, w))
    n = lib.flux_ppm_encode(px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, buf)
    return buf.raw[:n]
