"""The port's wire: the options it passes to ``msgpack``, pinned against
``msgpack``'s defaults on every frame type of the master↔node protocol and
on every form of each type, in both directions; what it refuses to read;
and the frames over a socket pair with ``flux_tpu.wire`` on the other end."""

import socket
import zlib
from pathlib import Path

import msgpack
import numpy as np
import pytest

from flux_tpu import wire as j_wire
from flux_tpu_torch import wire
from flux_tpu_torch.job import Job, JobConfiguration, JobID
from flux_tpu_torch.scene import load_scene

REPO = Path(__file__).resolve().parent.parent


def both_ways(obj):
    """The wire writes msgpack's bytes, and reads msgpack's bytes (and its
    own) to what msgpack reads."""
    want = msgpack.packb(obj, use_bin_type=True)
    got = wire.packb(obj)
    assert got == want
    decoded = msgpack.unpackb(want, raw=False)
    assert wire.unpackb(want) == decoded
    assert wire.unpackb(got) == decoded
    return decoded


def smooth_rows(n=4, w=64):
    y = np.linspace(0.0, 1.0, n * w * 3, dtype=np.float32)
    return (0.25 + 0.5 * y * y).reshape(n, w, 3)


def mesh_job():
    sd = load_scene(str(REPO / "scenes" / "demo5.yml"))
    return Job(JobID(2**47 + 3, 9), sd, JobConfiguration(32, 5, 50, seed=0, nee=True))


FRAMES = {
    "worker_info": {"type": "worker_info", "num_devices": 1, "platform": "cuda", "busy": False, "queued": 0},
    "set_job": {"type": "set_job", "job": mesh_job().to_dict(), "caps": ["zlib-rows"]},
    "work_unit": {"type": "work_unit", "row_start": 550, "row_end": 599},
    "done": {"type": "done"},
    "shutdown": {"type": "shutdown"},
    "rows_ready_zlib": wire.encode_rows(50, smooth_rows()),
    "rows_ready_raw": wire.encode_rows(0, smooth_rows(), allow_compress=False),
    "job_error": {"type": "job_error", "reason": "RuntimeError: CUDA error 700 — an illegal address"},
}


@pytest.mark.parametrize("kind", FRAMES)
def test_every_frame_type_matches_msgpack(kind):
    frame = FRAMES[kind]
    back = both_ways(frame)
    if kind == "set_job":
        assert len(frame["job"]["scene_data"]["shapes"]) > 16  # an array16 of shapes
        assert Job.from_dict(back["job"]) == mesh_job()
    if kind.startswith("rows_ready"):
        assert ("enc" in frame) == (kind == "rows_ready_zlib")
        assert np.array_equal(wire.decode_rows(back), smooth_rows())


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -0.0, 0.1, 1e300, float("inf"), -float("inf"), True, False, None,
], ids=repr)
def test_scalars_take_msgpacks_smallest_form(value):
    assert both_ways(value) == value


def test_nan_is_float64():
    got = wire.packb(float("nan"))
    assert got == msgpack.packb(float("nan")) and got[0] == 0xCB
    assert np.isnan(wire.unpackb(got))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536, 70000])
def test_every_length_form(n):
    """fix, 8-, 16- and 32-bit forms of str, bin, array and map (a mesh job
    of 2^16 triangles and more takes array32)."""
    both_ways("x" * n)
    both_ways("é" * n)
    both_ways(b"\x00\xff" * (n // 2) + b"y" * (n % 2))
    both_ways(list(range(n)))
    both_ways(tuple(float(i) for i in range(min(n, 300))))
    both_ways({f"k{i}": [i, None] for i in range(n)})


def test_decodes_what_msgpack_writes_in_other_forms():
    """float32 (msgpack's use_single_float) and bytes map keys."""
    assert wire.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert wire.unpackb(msgpack.packb({b"k": 1})) == {b"k": 1}


@pytest.mark.parametrize("bad, error", [
    (np.int64(3), TypeError),
    (object(), TypeError),
    (2**64, OverflowError),
])
def test_refuses_what_it_cannot_send(bad, error):
    with pytest.raises(error):
        wire.packb(bad)


@pytest.mark.parametrize("data", [b"\xc1", b"\xd4\x01\x00", b"\x92\x01", b"\x01\x02", b"\x81\x01\x02",
                                  b"\xd6\xff\x00\x00\x00\x00"],
                         ids=["never-used", "ext", "truncated", "trailing", "int-key", "timestamp"])
def test_refuses_what_it_cannot_read(data):
    with pytest.raises(ValueError):
        wire.unpackb(data)


@pytest.mark.parametrize("sender, receiver", [(wire, j_wire), (j_wire, wire), (wire, wire)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_frames_over_a_socket_between_the_packages(sender, receiver):
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        for frame in FRAMES.values():
            sender.send_msg(a, frame)
            got = receiver.recv_msg(b)
            assert got == msgpack.unpackb(msgpack.packb(frame, use_bin_type=True), raw=False)
        rows = smooth_rows(3, 16)
        sender.send_msg(a, sender.encode_rows(7, rows))
        assert np.array_equal(receiver.decode_rows(receiver.recv_msg(b)), rows)
    finally:
        a.close()
        b.close()


def test_rows_compression_is_gated_and_exact():
    smooth = smooth_rows()
    msg = wire.encode_rows(3, smooth)
    assert msg["enc"] == "zlib" and len(msg["data"]) < smooth.nbytes
    assert zlib.decompress(msg["data"]) == smooth.tobytes()
    assert msg == j_wire.encode_rows(3, smooth)
    noise = np.random.default_rng(0).integers(0, 2**32, (4, 64, 3), dtype=np.uint32).view(np.float32)
    raw = wire.encode_rows(0, noise)  # incompressible: sent raw
    assert "enc" not in raw and np.array_equal(wire.decode_rows(raw).view(np.uint32), noise.view(np.uint32))
    assert "enc" not in wire.encode_rows(0, smooth, allow_compress=False)


def test_a_frame_too_large_is_refused():
    a, b = socket.socketpair()
    b.settimeout(10)
    try:
        a.sendall((wire.MAX_FRAME + 1).to_bytes(4, "big"))
        with pytest.raises(ValueError, match="too large"):
            wire.recv_msg(b)
        a.close()
        with pytest.raises(ConnectionError):
            wire.recv_msg(b)
    finally:
        b.close()

