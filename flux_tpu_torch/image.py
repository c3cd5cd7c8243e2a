"""Row-oriented image store and writers (``flux_tpu/image.py``).

The PPM writer produces the reference's 16-bit ASCII P3 format with its
``value * 65535.99`` truncating quantization (fluxcore/src/image.rs:43-61),
byte for byte as ``flux_tpu.image.ppm_bytes`` does: through the native
encoder (``native.py``) where it loads, in Python otherwise. PNG output
(8-bit, via Pillow, imported only when a PNG is written) is a convenience.
"""

from __future__ import annotations

import io
import os

import numpy as np

__all__ = ["Image", "ppm_bytes", "ppm_bytes_python", "write_ppm", "read_ppm", "write_png"]


class Image:
    """Mutable row store: height × width × RGB float in [0, 1]. Rows may
    arrive in any order; rows never set stay black (image.rs:55-59).
    ``filled_rows`` says which rows were set."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.pixels = np.zeros((self.height, self.width, 3), np.float32)
        self._filled = np.zeros(self.height, bool)

    def set_row(self, row_index: int, values: np.ndarray) -> None:
        values = np.asarray(values, np.float32)
        if values.shape != (self.width, 3):
            raise ValueError(f"row shape {values.shape} != ({self.width}, 3)")
        self.pixels[row_index] = values
        self._filled[row_index] = True

    def set_pixel(self, row_index: int, col_index: int, value) -> None:
        self.pixels[row_index, col_index] = np.asarray(value, np.float32)
        self._filled[row_index] = True

    @property
    def filled_rows(self) -> np.ndarray:
        return self._filled.copy()

    def complete(self) -> bool:
        return bool(self._filled.all())

    def set_rows(self, row_start: int, values: np.ndarray) -> None:
        values = np.asarray(values, np.float32)
        if values.ndim != 3 or values.shape[1:] != (self.width, 3):
            raise ValueError(f"rows shape {values.shape} != (n, {self.width}, 3)")
        n = values.shape[0]
        if row_start < 0 or row_start + n > self.height:
            raise ValueError(
                f"rows [{row_start}, {row_start + n}) outside image height {self.height}"
            )
        self.pixels[row_start : row_start + n] = values
        self._filled[row_start : row_start + n] = True


def ppm_bytes(pixels: np.ndarray) -> bytes:
    """Encode (H, W, 3) floats as 16-bit ASCII PPM (P3), one pixel per line:
    the native encoder where it loads, else this Python version, which gives
    the same bytes."""
    from .native import ppm_encode_native

    native = ppm_encode_native(np.asarray(pixels, np.float32))
    if native is not None:
        return native
    return ppm_bytes_python(pixels)


def ppm_bytes_python(pixels: np.ndarray) -> bytes:
    """The Python P3 encoder (what :func:`ppm_bytes` falls back to)."""
    h, w = pixels.shape[:2]
    q = (np.asarray(pixels, np.float64) * 65535.99).astype(np.uint16)
    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n65535\n")
    buf.write("\n".join(f"{r} {g} {b}" for r, g, b in q.reshape(-1, 3).tolist()))
    buf.write("\n")
    return buf.getvalue().encode()


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def write_ppm(path: str, img: "Image | np.ndarray") -> None:
    pixels = img.pixels if isinstance(img, Image) else np.asarray(img)
    _ensure_parent(path)
    with open(path, "wb") as f:
        f.write(ppm_bytes(pixels))


def write_png(path: str, img: "Image | np.ndarray") -> None:
    from PIL import Image as PILImage

    pixels = img.pixels if isinstance(img, Image) else np.asarray(img)
    _ensure_parent(path)
    arr8 = (np.clip(pixels, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    PILImage.fromarray(arr8, "RGB").save(path)


def read_ppm(path: str) -> np.ndarray:
    """Parse a P3 PPM back to (H, W, 3) floats."""
    with open(path, "rb") as f:
        tokens = f.read().split()
    if tokens[0] != b"P3":
        raise ValueError("only ASCII P3 PPM is supported")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.array(tokens[4 : 4 + w * h * 3], dtype=np.float64).reshape(h, w, 3)
    return (data / maxv).astype(np.float32)
