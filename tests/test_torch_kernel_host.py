"""The host-side parts of the CUDA megakernels' launches, on the CPU: the
launch plan's cover of pixels and samples, and the triangle skip's rule by
block count.

A launch cuts its band into blocks of
``256 / split`` pixels × ``split`` threads, each thread taking every
split-th sample of its pixel (csrc/flux_trace.cuh ``render_pixels``); that
index scheme is restated here and must cover every pixel and every sample
below ``s_limit`` exactly once. Nothing here needs a card.
"""

import os

import numpy as np
import pytest
import torch

from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.ops.intersect import Intersector, tri_layout
from flux_tpu_torch.ops.scene_kernel import pack_geom, render_block_scene, tri_skip_engaged
from flux_tpu_torch.ops.sweep_kernel import SPLITS, launch_plan
from flux_tpu_torch.scene import compile_scene, load_scene

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes")


def _coverage(plan, n_pix, s0, n_samples, s_limit):
    """How often the kernel's index scheme under ``plan`` visits each
    (pixel, sample): block b, thread (tx, ty) owns pixel b·P + tx and the
    samples s0 + k, k = ty, ty + split, ... < n_samples, below s_limit."""
    px, split = plan.pixels_per_block, plan.split
    assert px * split == 256 and split in SPLITS
    seen = np.zeros((n_pix, n_samples), np.int64)
    for b in range(plan.blocks):
        for tx in range(px):
            pix = b * px + tx
            if pix >= n_pix:
                continue
            for ty in range(split):
                k = np.arange(ty, n_samples, split)
                k = k[(s0 + k) % 2**32 < s_limit]
                seen[pix, k] += 1
    return seen


PLAN_CASES = [
    # n_pix, s0, n_samples, s_limit, slots
    (800 * 3 + 5, 0, 64, 2**32, 8),  # a ragged last block
    (333, 10, 37, 2**32, 1000),  # n_samples not a multiple of any split
    (1000, 100, 50, 130, 4),  # s_limit cuts the range
    (40, 0, 3, 2**32, 2),  # fewer samples than threads per pixel
]


@pytest.mark.parametrize("n_pix, s0, n_samples, s_limit, slots", PLAN_CASES)
def test_launch_plan_covers_each_pixel_and_sample_once(n_pix, s0, n_samples, s_limit, slots):
    plan = launch_plan(n_pix, n_samples, slots)
    assert plan.blocks == -(-n_pix // plan.pixels_per_block) and plan.slots == slots
    seen = _coverage(plan, n_pix, s0, n_samples, s_limit)
    want = ((s0 + np.arange(n_samples)) < s_limit).astype(np.int64)
    np.testing.assert_array_equal(seen, np.broadcast_to(want, seen.shape))


def test_launch_plan_cuts_long_launches_against_the_wave_tail():
    """A demo2 band (40,000 pixels at 16384 spp) on an H100's 528 slots: 8
    threads a pixel make 2.4 waves of 2048 samples each; the plan takes more
    threads a pixel so that the last wave leaves less of the card idle. A
    short launch keeps the smallest split."""
    plan = launch_plan(40000, 16384)
    assert plan.split > 8 and plan.slots == 528
    waves = plan.waves
    assert (np.ceil(waves) - waves) / np.ceil(waves) < 0.1
    assert launch_plan(6400, 4).split == 8


def test_tri_skip_rule_by_block_count():
    assert not tri_skip_engaged(3)
    assert tri_skip_engaged(80)
    assert tri_skip_engaged(scene_kernel.TRI_SKIP_ENGAGE) and not tri_skip_engaged(scene_kernel.TRI_SKIP_ENGAGE - 1)


def test_tri_skip_default_by_block_count_on_a_small_demo5_band():
    """demo5 (36 triangles in 3 blocks): the launch parameters take the skip
    off by default and on when forced; on the CPU, where the wrapper runs
    the plain version, the three choices give the same bits."""
    dev = torch.device("cpu")
    sd = load_scene(os.path.join(SCENES, "demo5.yml"))
    sc = compile_scene(sd, dev)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, dev)
    isect = Intersector(mode="sweep", tri_layout=tri_layout(sc))
    assert isect.tri_layout.n_blocks == 3
    assert pack_geom(sc, isect, None, dev)[0].tri_skip == 0
    assert pack_geom(sc, isect, None, dev, tri_skip=True)[0].tri_skip == 1
    kw = dict(isect=isect, img_w=512, img_h=512, n_rows=1, n_samples=2, root=2, max_depth=2)
    base = render_block_scene(sc, cam, 256, 0, 3, **kw)
    for forced in (True, False):
        other = render_block_scene(sc, cam, 256, 0, 3, tri_skip=forced, **kw)
        assert torch.equal(base.view(torch.int32), other.view(torch.int32))
