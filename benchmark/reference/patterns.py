"""Per-index stratified 2-D sample patterns (regular / jittered / MJ / CMJ).

The functions of ``flux_tpu/samplers/patterns.py``: ``point(s, root,
pattern) -> (x, y)`` of the sample index ``s`` in ``[0, root²)`` and a uint32
pattern id. Sample ``s`` owns coarse cell ``(i, j) = (s % root, s // root)``;
MJ and CMJ place it in a fine stratum by a Kensler permutation, exact for a
power-of-two ``root`` and the canonical n-rooks arrangement otherwise.

Every division is by a tensor (:func:`flux_tpu_torch.vec.div`), so it is
correctly rounded on the card as on the CPU, and the points equal the JAX
package's bit for bit.
"""

import torch

from .vec import div
from .hash import hash_combine, permute_pow2, randfloat, u32

__all__ = ["regular_point", "jittered_point", "mj_point", "cmj_point", "bounce_point", "point"]

# Purpose salts so that x/y jitters and permutations never collide.
_SALT_JX = 0x16A3D5C7
_SALT_JY = 0x2C9F1B4F
_SALT_PX = 0x51633E2D
_SALT_PY = 0x68BC21EB


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _f32(u):
    return u.to(torch.float32)


def regular_point(s, root: int, pattern=0):
    """Center of cell s of the root×root grid (lib.rs:184-191)."""
    s = u32(s)
    r = float(root)
    i = _f32(s % root)
    j = _f32(s // root)
    return div(i + 0.5, r), div(j + 0.5, r)


def jittered_point(s, root: int, pattern):
    """One uniform point per root×root cell (lib.rs:35-44)."""
    s = u32(s)
    r = float(root)
    i = _f32(s % root)
    j = _f32(s // root)
    jx = randfloat(s, hash_combine(pattern, _SALT_JX))
    jy = randfloat(s, hash_combine(pattern, _SALT_JY))
    return div(i + jx, r), div(j + jy, r)


def _multi_jitter(s, root: int, pattern, correlated: bool):
    s = u32(s)
    r = float(root)
    i = s % root  # coarse column
    j = s // root  # coarse row
    if _is_pow2(root):
        if correlated:
            px = hash_combine(pattern, _SALT_PX)
            py = hash_combine(pattern, _SALT_PY)
        else:
            px = hash_combine(pattern, _SALT_PX, i)
            py = hash_combine(pattern, _SALT_PY, j)
        fine_x = _f32(permute_pow2(j, root, px))
        fine_y = _f32(permute_pow2(i, root, py))
    else:
        # Canonical arrangement: n-rooks by construction, no shuffle.
        fine_x = _f32(j)
        fine_y = _f32((root - 1) - i)
    jx = randfloat(s, hash_combine(pattern, _SALT_JX))
    jy = randfloat(s, hash_combine(pattern, _SALT_JY))
    x = div(_f32(i) + div(fine_x + jx, r), r)
    y = div(_f32(j) + div(fine_y + jy, r), r)
    return x, y


def mj_point(s, root: int, pattern):
    """Multi-jittered sample s of root² (table analog: lib.rs:46-73)."""
    return _multi_jitter(s, root, pattern, correlated=False)


def cmj_point(s, root: int, pattern):
    """Correlated multi-jittered sample s of root² (lib.rs:75-90)."""
    return _multi_jitter(s, root, pattern, correlated=True)


def bounce_point(s, root: int, pattern, depth: int):
    """Stratified 2-D sample for bounce ``depth``: MJ at the first bounce,
    plain jittered beyond (``flux_tpu/samplers/patterns.py::bounce_point``)."""
    return mj_point(s, root, pattern) if depth <= 1 else jittered_point(s, root, pattern)


_KINDS = {
    "regular": regular_point,
    "jittered": jittered_point,
    "mj": mj_point,
    "cmj": cmj_point,
}


def point(kind: str, s, root: int, pattern):
    """Dispatch by pattern-kind name."""
    return _KINDS[kind](s, root, pattern)
