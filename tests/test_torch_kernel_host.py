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


# ---- the upload of the kernels' __constant__ records ----------------------


class _Stream:
    """A CUDA stream's stand-in: the events it was told to wait on."""

    def __init__(self, handle):
        self.cuda_stream = handle
        self.waits = []

    def wait_event(self, event):
        self.waits.append(event)


class _Event:
    """A CUDA event's stand-in, which has ended once the test says so."""

    def __init__(self):
        self.stream, self.done = None, False

    def record(self, stream):
        self.stream = stream

    def query(self):
        return self.done


class _Library:
    """A loaded kernel library's stand-in: each upload it was asked for, as
    (scene sent, lights sent, stream); ``error`` is what an upload returns."""

    def __init__(self, handle):
        self._handle = handle
        self.uploads = []
        self.error = 0

    def flux_sweep_upload(self, scene, lights, stream):
        self.uploads.append((scene is not None, lights is not None, stream))
        return self.error

    def flux_scene_upload(self, scene, stream):
        self.uploads.append((True, False, stream))
        return self.error


def _records(name, nee=False):
    """The sweep kernel's scene record of ``scenes/<name>.yml`` (and its light
    record with ``nee``), packed from the scene's CPU tensors."""
    from flux_tpu_torch.ops.nee import extract_lights
    from flux_tpu_torch.ops.sweep_kernel import pack_lights, pack_scene

    dev = torch.device("cpu")
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, dev)
    scene = pack_scene(compile_scene(sd, dev), cam)
    return (scene, pack_lights(extract_lights(sd, dev))) if nee else scene


def _send(kernel, lib, device, stream, scene, sent, lights=None):
    from flux_tpu_torch.ops import sweep_kernel

    if kernel == "sweep":
        return sweep_kernel.send_records(lib, device, stream, scene, lights, sent=sent)
    return scene_kernel.send_records(lib, device, stream, scene, sent=sent)


@pytest.mark.parametrize("kernel", ["sweep", "scene"])
def test_a_scene_record_goes_up_once_for_each_change(kernel):
    """Launches of one scene send its record once; a second scene sends
    its own, and going back to the first sends that again."""
    from flux_tpu_torch.ops.build import SentRecords

    sent, lib, stream = SentRecords(_Event), _Library(1), _Stream(7)
    demo2, demo1 = _records("demo2"), _records("demo1")
    got = [_send(kernel, lib, 0, stream, rec, sent) for rec in (demo2, demo2, demo2, demo1, demo1, demo2)]
    assert got == [True, False, False, True, False, True]
    assert lib.uploads == [(True, False, 7)] * 3


@pytest.mark.parametrize("kernel", ["sweep", "scene"])
def test_scene_records_are_kept_apart_per_device_and_per_library(kernel):
    """What one library holds on one device says nothing of another card
    or of another library (a kernel source's build, a variant of it): each
    takes its own upload, once."""
    from flux_tpu_torch.ops.build import SentRecords

    sent, stream = SentRecords(_Event), _Stream(7)
    a, b = _Library(1), _Library(2)
    demo2 = _records("demo2")
    got = [_send(kernel, lib, dev, stream, demo2, sent) for lib, dev in ((a, 0), (a, 1), (b, 0), (a, 0), (a, 1),
                                                                           (b, 0), (b, 1))]
    assert got == [True, True, True, False, False, False, True]
    assert len(a.uploads) == 2 and len(b.uploads) == 2


def test_the_sweep_kernels_light_record_goes_up_only_when_it_changes():
    """demo2 with NEE: the scene and light records go up together once; a
    launch without NEE sends neither; a changed light record goes up alone."""
    from flux_tpu_torch.ops.build import SentRecords
    from flux_tpu_torch.ops.sweep_kernel import FluxLights

    sent, lib, stream = SentRecords(_Event), _Library(1), _Stream(7)
    scene, lights = _records("demo2", nee=True)
    other = FluxLights.from_buffer_copy(bytes(lights))
    other.emit[0][0] += 1.0
    got = [_send("sweep", lib, 0, stream, scene, sent, lights=rec) for rec in (lights, None, lights, other)]
    assert got == [True, False, False, True]
    assert lib.uploads == [(True, True, 7), (False, True, 7)]


@pytest.mark.parametrize("kernel", ["sweep", "scene"])
def test_an_upload_waits_for_the_launches_still_reading_the_record(kernel):
    """Two launch streams: a new scene's upload on one waits on the other's
    launch while that runs, and not on a launch that has ended nor on its
    own stream's; a launch that sends nothing waits on another stream's
    upload while that is queued, and on nothing once it has ended."""
    from flux_tpu_torch.ops.build import SentRecords

    sent, lib = SentRecords(_Event), _Library(1)
    s0, s1 = _Stream(10), _Stream(11)
    demo2, demo1 = _records("demo2"), _records("demo1")
    assert _send(kernel, lib, 0, s0, demo2, sent)
    up0 = sent._state(lib, 0)["uploaded"][1]
    sent.launched(lib, 0, s0)
    running = sent._state(lib, 0)["in_flight"][10]
    # The same record on the other stream: nothing sent, the upload awaited.
    assert not _send(kernel, lib, 0, s1, demo2, sent)
    assert s1.waits == [up0]
    sent.launched(lib, 0, s1)
    up0.done = True
    assert not _send(kernel, lib, 0, s0, demo2, sent) and s0.waits == []
    # A new scene on stream 0 waits on stream 1's running launch only.
    assert _send(kernel, lib, 0, s0, demo1, sent)
    assert s0.waits == [sent._state(lib, 0)["in_flight"][11]] and running not in s0.waits
    # Once every launch has ended, a new scene waits on none.
    sent.launched(lib, 0, s0)
    for e in sent._state(lib, 0)["in_flight"].values():
        e.done = True
    s1.waits.clear()
    assert _send(kernel, lib, 0, s1, demo2, sent) and s1.waits == []
    assert len(lib.uploads) == 3


def test_a_failed_upload_raises_and_is_sent_again():
    """An upload that returns a CUDA error raises, and the record counts as
    unknown: the next launch sends it again, even where it is the record
    sent before the failed one."""
    from flux_tpu_torch.ops.build import SentRecords

    sent, lib, stream = SentRecords(_Event), _Library(1), _Stream(7)
    demo2, demo1 = _records("demo2"), _records("demo1")
    lib.error = 700
    with pytest.raises(RuntimeError, match="700"):
        _send("sweep", lib, 0, stream, demo2, sent)
    lib.error = 0
    assert _send("sweep", lib, 0, stream, demo2, sent)
    assert not _send("sweep", lib, 0, stream, demo2, sent)
    lib.error = 700
    with pytest.raises(RuntimeError, match="700"):
        _send("sweep", lib, 0, stream, demo1, sent)
    lib.error = 0
    assert _send("sweep", lib, 0, stream, demo2, sent)
    assert len(lib.uploads) == 4
