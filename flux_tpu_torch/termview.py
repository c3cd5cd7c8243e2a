"""In-terminal live render preview for headless hosts
(``flux_tpu/termview.py``).

The reference opens an SDL2 window and blits finished rows at 60 Hz
(flux/src/main.rs:216-323). A host with a CUDA card usually has no display,
so the preview is drawn in the terminal itself, and a progressive PNG file
is written beside it:

* the **kitty graphics protocol** when the terminal supports it (true
  pixels, detected from $TERM / $KITTY_WINDOW_ID; needs Pillow),
* **ANSI 24-bit half-block cells** otherwise (two image rows per character
  row via the upper-half-block glyph, downsampled to the terminal size),
* nothing when stdout is not a TTY (the PNG file remains).

Frames redraw in place (cursor-up rewind), so the render appears to
develop inside the terminal like the reference's window.
"""

from __future__ import annotations

import base64
import io
import os
import sys
from typing import Optional

import numpy as np

__all__ = ["TermPreview", "ansi_halfblock", "detect_mode"]

_UPPER_HALF = "▀"  # ▀ upper half block


def detect_mode(stream=None, env=None) -> Optional[str]:
    """'kitty' | 'ansi' | None for the given stream (default stdout)."""
    stream = stream if stream is not None else sys.stdout
    env = env if env is not None else os.environ
    if not hasattr(stream, "isatty") or not stream.isatty():
        return None
    if env.get("KITTY_WINDOW_ID") or "kitty" in env.get("TERM", ""):
        return "kitty"
    if env.get("TERM", "") in ("dumb", ""):
        return None
    return "ansi"


def _downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Box-average (H, W, 3) float [0,1] to (out_h, out_w, 3) uint8."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h + 1) * h // out_h).clip(0, h)
    xs = (np.arange(out_w + 1) * w // out_w).clip(0, w)
    # Integral image makes the box means O(1) per cell.
    ii = np.pad(np.cumsum(np.cumsum(img, 0), 1), ((1, 0), (1, 0), (0, 0)))
    sums = (
        ii[ys[1:, None], xs[None, 1:]]
        - ii[ys[:-1, None], xs[None, 1:]]
        - ii[ys[1:, None], xs[None, :-1]]
        + ii[ys[:-1, None], xs[None, :-1]]
    )
    areas = ((ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]).clip(min=1)
    out = sums / areas[..., None]
    return (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def ansi_halfblock(img: np.ndarray, max_cols: int = 80, max_rows: int = 24) -> str:
    """Render (H, W, 3) float pixels as ANSI 24-bit half-block art.

    Each character cell shows two vertically-adjacent downsampled pixels
    (foreground = upper, background = lower), preserving the image aspect
    ratio within (max_cols, max_rows) text cells."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    # A text cell is ~2x taller than wide; half-blocks give 2 pixels/cell,
    # so pixel aspect is ~square. Fit (w, h) into (max_cols, 2*max_rows).
    scale = min(max_cols / w, (2 * max_rows) / h, 1.0)
    out_w = max(1, int(w * scale))
    out_h = max(2, int(h * scale) & ~1)  # even number of pixel rows
    small = _downsample(img, out_h, out_w)
    lines = []
    for y in range(0, out_h, 2):
        parts = []
        prev = None
        for x in range(out_w):
            tr, tg, tb = small[y, x]
            br, bg_, bb = small[y + 1, x]
            key = (tr, tg, tb, br, bg_, bb)
            if key != prev:  # skip redundant SGR sequences
                parts.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m"
                )
                prev = key
            parts.append(_UPPER_HALF)
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def _kitty_payload(img: np.ndarray) -> str:
    """Kitty graphics 'transmit and display' escape for an RGB image."""
    from PIL import Image as PILImage

    arr = (np.clip(np.asarray(img, np.float32), 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    PILImage.fromarray(arr).save(buf, format="PNG")
    b64 = base64.standard_b64encode(buf.getvalue()).decode()
    chunks = [b64[i : i + 4096] for i in range(0, len(b64), 4096)]
    out = []
    for k, chunk in enumerate(chunks):
        first = k == 0
        last = k == len(chunks) - 1
        ctrl = ("a=T,f=100,q=1," if first else "") + f"m={0 if last else 1}"
        out.append(f"\x1b_G{ctrl};{chunk}\x1b\\")
    return "".join(out)


class TermPreview:
    """Stateful in-place terminal preview; safe to call with no TTY (noop).

    ``update(img)`` draws the current frame over the previous one;
    ``close()`` moves the cursor past the drawing."""

    def __init__(self, stream=None, mode: Optional[str] = "auto",
                 max_cols: Optional[int] = None, max_rows: Optional[int] = None):
        self._stream = stream if stream is not None else sys.stdout
        self.mode = detect_mode(self._stream) if mode == "auto" else mode
        if max_cols is None or max_rows is None:
            try:
                ts = os.get_terminal_size(self._stream.fileno())
                cols, rows = ts.columns, ts.lines
            except (OSError, ValueError, AttributeError):
                cols, rows = 80, 24
            # Clamp DOWN to the real terminal: emitting lines wider than the
            # terminal wraps them, and the cursor-up rewind below counts
            # logical lines, not wrapped physical rows.
            max_cols = max_cols or max(cols, 1)
            max_rows = max_rows or max(rows - 4, 1)
        self._max_cols = max_cols
        self._max_rows = max_rows
        self._drawn_lines = 0

    def update(self, img: np.ndarray, status: Optional[str] = None) -> None:
        """Redraw the frame in place; ``status``, if given, is drawn as one
        extra line under the art and counted in the rewind accounting (a
        caller print()ing between updates would break it — route per-pass
        status through here instead)."""
        if self.mode is None:
            return
        s = self._stream
        tail = ""
        if status is not None:
            # One line, clipped to the art budget, cleared to end-of-line so
            # a shorter status fully replaces a longer previous one.
            tail = status.replace("\n", " ")[: self._max_cols] + "\x1b[K\n"
        if self.mode == "kitty":
            if self._drawn_lines:
                s.write(f"\x1b[{self._drawn_lines}A\r")
            s.write("\x1b_Ga=d,q=1\x1b\\")  # delete previous image
            s.write(_kitty_payload(img))
            s.write("\n" + tail)
            self._drawn_lines = 1 + (1 if status is not None else 0)
            s.flush()
            return
        art = ansi_halfblock(img, self._max_cols, self._max_rows)
        n = art.count("\n") + 1
        if self._drawn_lines:
            s.write(f"\x1b[{self._drawn_lines}A\r")
        s.write(art + "\x1b[0m\n" + tail)
        self._drawn_lines = n + (1 if status is not None else 0)
        s.flush()

    def close(self) -> None:
        self._drawn_lines = 0
