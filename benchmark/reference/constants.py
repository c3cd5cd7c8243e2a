"""Numeric constants shared across the package.

The same values as ``flux_tpu/constants.py``: the ray self-intersection
epsilon ``T_MIN`` of the reference (fluxcore/src/constants.rs:4) and the
purpose salts that keep the sample streams of a pixel independent. The salts
must stay equal to the JAX package's, or the sample streams diverge.
"""

# Minimum ray parameter for a valid intersection (ray epsilon).
T_MIN = 5e-4

# Purpose salts separating the independent sample streams of a pixel.
SALT_AA = 0x41415341
SALT_LENS = 0x4C454E53
SALT_BOUNCE = 0x424F554E
SALT_NEE = 0x4E454531
SALT_NEEPICK = 0x4E454532

# Default TCP port of a render node (fluxcore/src/constants.rs:6).
DEFAULT_PORT = 2000
