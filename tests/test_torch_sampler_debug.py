"""The port's sample grids, ``Sampler`` and ``sampler-debug`` against
``flux_tpu``'s: every grid and each draw of ``Sampler`` bit for bit, for
roots 1-10 and seeds 0-2, and the eight PPMs byte for byte. The JAX grids
run eagerly (a few integer ops per table; nothing is compiled that a
render needs)."""

import numpy as np
import pytest

from flux_tpu import sampler_debug as j_sampler_debug
from flux_tpu.samplers import grids as j_grids
from flux_tpu_torch import sampler_debug
from flux_tpu_torch.samplers import grids

ROOTS = range(1, 11)
KINDS = ["grid_jittered", "grid_multi_jittered", "grid_correlated_multi_jittered"]


def equal_bits(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("root", ROOTS)
def test_grids_equal_jax(root):
    equal_bits(grids.grid_regular(root, device="cpu"), j_grids.grid_regular(root))
    for kind in KINDS:
        for pattern in (0, 1, 0x9E3779B9):
            equal_bits(getattr(grids, kind)(root, pattern, device="cpu"), getattr(j_grids, kind)(root, pattern))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_draws_equal_jax(seed):
    """Each draw takes the next pattern id: three draws of every kind in
    turn, each root of 1-10."""
    mine, theirs = grids.Sampler(seed, device="cpu"), j_grids.Sampler(seed)
    for root in ROOTS:
        for kind in KINDS * 3:
            equal_bits(getattr(mine, kind)(root), getattr(theirs, kind)(root))


@pytest.mark.parametrize("root, seed", [(10, 0), (4, 2)])
def test_sampler_debug_writes_jax_packages_ppms(tmp_path, root, seed):
    names = [f"sampler-debug-{b}{s}.ppm" for b in ("r", "j", "mj", "cmj") for s in ("", "-hemi")]
    assert j_sampler_debug.main(["-r", str(root), "--seed", str(seed), "--output-dir", str(tmp_path / "j")]) == 0
    assert sampler_debug.main(["-r", str(root), "--seed", str(seed), "--device", "cpu",
                               "--output-dir", str(tmp_path / "t")]) == 0
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_sampler_debug_needs_the_card_unless_told_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler_debug.main(["-r", "2", "--output-dir", str(tmp_path)])
