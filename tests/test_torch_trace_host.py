"""The CUDA kernels' sampler path, compiled for the CPU with g++, against
the port's samplers: bit for bit.

csrc/flux_trace.cuh computes, once per pixel, a row of every hash of the
pixel's sample streams that does not depend on the sample index (its
``sampler_word``); ``multi_jitter``, ``jittered`` and ``bounce_point``
then take the row's words and the sample's cell. The header compiles as host
code against the ``cuda_runtime.h`` stand-in in csrc/host/ (g++ -O2
-ffp-contract=off: integer hashing and correctly rounded float32 division,
as on the card); a small program prints, for each sample, the CMJ
anti-aliasing and lens points and, at depths 1-5, the bounce point, the
light-sample point and the light pick, which must equal
:mod:`flux_tpu_torch.samplers` exactly. Skips where g++ is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from flux_tpu_torch.constants import SALT_AA, SALT_BOUNCE, SALT_LENS, SALT_NEE, SALT_NEEPICK
from flux_tpu_torch.samplers.hash import hash_combine, randfloat
from flux_tpu_torch.samplers.patterns import bounce_point, cmj_point

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "flux_tpu_torch", "csrc")
DEPTH = 5

# Reads lines "seed row col root n s_1 .. s_n"; for each s prints the float
# bits of every point of the NEE row layout.
PROGRAM = r"""
#include <stdio.h>
#define CHECK_DEPTH {depth}
#include "flux_trace.cuh"

int main() {
  unsigned seed, y, x, root, n;
  while (scanf("%u %u %u %u %u", &seed, &y, &x, &root, &n) == 5) {
    const uint32_t base = hash3(seed, y, x);
    uint32_t row[256];
    for (int w = 0; w < ROW_DEPTH0 + row_per_depth(true) * CHECK_DEPTH; ++w) row[w] = sampler_word<true>(base, w);
    for (unsigned k = 0; k < n; ++k) {
      unsigned s;
      if (scanf("%u", &s) != 1) return 1;
      const uint32_t i = s % root, j = s / root;
      float p[4 + 5 * CHECK_DEPTH];
      multi_jitter(s, i, j, root, row + ROW_AA, true, &p[0], &p[1]);
      multi_jitter(s, i, j, root, row + ROW_LENS, true, &p[2], &p[3]);
      for (int d = 1; d <= CHECK_DEPTH; ++d) {
        const uint32_t* w = row + ROW_DEPTH0 + (d - 1) * row_per_depth(true);
        float* q = p + 4 + 5 * (d - 1);
        bounce_point(s, i, j, root, w, d, &q[0], &q[1]);
        bounce_point(s, i, j, root, w + ROW_NEE, d, &q[2], &q[3]);
        q[4] = randfloat(s, w[ROW_PICK]);
      }
      for (float f : p) printf("%u ", (unsigned)__float_as_int(f));
      printf("\n");
    }
  }
  return 0;
}
"""

CASES = [(0, 0, 0), (42, 296, 17), (7, 599, 799), (0xDEADBEEF, 3, 5)]
ROOTS = [1, 2, 3, 4, 5, 8, 128]


def _samples(root: int) -> np.ndarray:
    if root <= 8:
        return np.arange(root * root, dtype=np.int64)
    rng = np.random.default_rng(root)
    return np.unique(np.concatenate([[0, 1, root - 1, root, root * root - 1],
                                     rng.integers(0, root * root, 120)])).astype(np.int64)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy().view(np.uint32).astype(np.int64)


def _expected(seed, y, x, root, s):
    """The port's samplers: the same points as the compiled program."""
    st = torch.from_numpy(s)
    base = hash_combine(seed, y, x)
    cols = []
    for salt in (SALT_AA, SALT_LENS):
        cols += cmj_point(st, root, hash_combine(base, salt))
    for d in range(1, DEPTH + 1):
        cols += bounce_point(st, root, hash_combine(base, SALT_BOUNCE, d), d)
        cols += bounce_point(st, root, hash_combine(base, SALT_NEE, d), d)
        cols.append(randfloat(st, hash_combine(base, SALT_NEEPICK, d)))
    return np.stack([_bits(c) for c in cols], axis=1)


def test_sampler_rows_match_the_samplers(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = tmp_path / "samplers.cpp"
    src.write_text(PROGRAM.replace("{depth}", str(DEPTH)))
    exe = tmp_path / "samplers"
    built = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", os.path.join(CSRC, "host"),
                            "-I", CSRC, "-o", str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    lines, want = [], []
    for seed, y, x in CASES:
        for root in ROOTS:
            s = _samples(root)
            lines.append(" ".join(map(str, (seed, y, x, root, len(s), *s.tolist()))))
            want.append(_expected(seed, y, x, root, s))
    out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", check=True, capture_output=True,
                         text=True, timeout=60).stdout
    got = np.array([list(map(int, ln.split())) for ln in out.splitlines()], np.int64)
    np.testing.assert_array_equal(got, np.concatenate(want))
