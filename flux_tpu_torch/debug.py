"""Timestamped debug tracing (``flux_tpu/debug.py``; fluxcore/src/debug.rs).

The reference compiles ``d_println`` out of release builds
(debug.rs:4-13); here the switch is the ``FLUX_TPU_DEBUG`` environment
variable or :func:`set_debug`.
"""

from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["d_println", "set_debug", "debug_enabled"]

_enabled = bool(int(os.environ.get("FLUX_TPU_DEBUG", "0")))
_lock = threading.Lock()


def set_debug(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def debug_enabled() -> bool:
    return _enabled


def d_println(msg: str) -> None:
    """Print ``msg`` to stderr with a milliseconds-since-epoch timestamp
    when debug tracing is on (debug.rs:5-12)."""
    if _enabled:
        with _lock:
            print(f"{int(time.time() * 1000)}: {msg}", file=sys.stderr, flush=True)
