"""Counter-based uint32 hashing for deterministic, stateless sampling.

The same functions as ``flux_tpu/samplers/hash.py`` (Kensler, "Correlated
Multi-Jittered Sampling", Pixar Technical Memo 13-01, and a murmur3-style
finalizer), bit for bit: every random number of a render is a pure function
of (seed, pixel, sample, depth, purpose).

PyTorch's CPU ``uint32`` lacks ``>>``, ``<<``, ``+``, ``//`` and ``%``, so a
uint32 value is carried here as an int64 tensor (or a Python int) in
``[0, 2**32)``. Every operation that can leave that range (multiply, add,
left shift) is masked back with ``& MASK`` at once, so every right shift sees
a non-negative value: an unmasked negative int64 would shift arithmetically
and silently change every pattern id. An int64 product of two uint32 values
may wrap past 2**63; its low 32 bits, which the mask keeps, are still exact.
"""

import torch

__all__ = ["MASK", "mix", "hash_combine", "randfloat", "permute_pow2"]

MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def u32(x):
    """A uint32 value as an int64 tensor, or a Python int, in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def mix(x):
    """32-bit avalanche finalizer (murmur3-style). uint32 -> uint32."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK
    return x ^ (x >> 16)


def hash_combine(*vals):
    """Fold integer values (Python ints or tensors, broadcast together) into
    one well-mixed uint32."""
    acc = _GOLDEN
    for v in vals:
        acc = mix(acc ^ ((u32(v) + _GOLDEN + ((acc << 6) & MASK) + (acc >> 2)) & MASK))
    return acc


def randfloat(i, p):
    """Hash (index, pattern) to a float32 uniform in [0, 1): the top 24 bits
    of the finalizer, scaled exactly."""
    i = mix(torch.as_tensor(u32(i)) ^ u32(p))
    return (i >> 8).to(torch.float32) * (1.0 / (1 << 24))


def permute_pow2(i, l: int, p):
    """Pseudo-random bijection of [0, l) keyed by pattern ``p``; ``l`` is a
    power of two (Kensler's permutation network, no cycle walking)."""
    if l <= 0 or l & (l - 1):
        raise ValueError("permute_pow2 requires a power-of-two domain")
    w = l - 1
    i = u32(i)
    p = u32(p)
    i = i ^ p
    i = (i * 0xE170893D) & MASK
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = (i * 0x0929EB3F) & MASK
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = (i * (1 | (p >> 27))) & MASK
    i = (i * 0x6935FA69) & MASK
    i = i ^ ((i & w) >> 11)
    i = (i * 0x74DCCA23) & MASK
    i = i ^ (p >> 2)
    i = (i * 0x9E501CC3) & MASK
    i = i ^ ((i & w) >> 2)
    i = (i * 0xC860A3DF) & MASK
    i = i & w
    i = i ^ (i >> 5)
    return ((i + p) & MASK) & w
