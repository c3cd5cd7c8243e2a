"""Length-prefixed msgpack framing for the master↔node link
(``flux_tpu/wire.py``).

The reference streams CBOR values over raw TCP (workers.rs:8-10,126-159,
flux-node/src/main.rs:10-12). As in ``flux_tpu``, each frame is a 4-byte
big-endian length followed by one msgpack map, and row blocks travel as raw
float32 bytes and a shape, zlib-deflated where the peer advertised the
``zlib-rows`` capability.

Frames are written by ``msgpack.packb(obj, use_bin_type=True)``, as in
``flux_tpu``, and read by :func:`unpackb`, which refuses what the protocol
never sends: ext types (the timestamp among them), map keys that are not
str or bytes, and bytes past the value.
"""

from __future__ import annotations

import socket
import struct
import zlib

import msgpack
import numpy as np

__all__ = ["send_msg", "recv_msg", "encode_rows", "decode_rows", "packb", "unpackb"]

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30


def _refuse_ext(code: int, data: bytes):
    raise ValueError(f"msgpack ext type {code} is not part of the protocol")


def packb(obj) -> bytes:
    """The msgpack bytes of ``obj``: the smallest form of each int, str and
    container length, floats as float64, bytes as bin."""
    return msgpack.packb(obj, use_bin_type=True)


def unpackb(data) -> object:
    """Decode one msgpack value: str as str, bin as bytes, arrays as lists.
    Every failure is a ``ValueError``. msgpack decodes its timestamp type
    without calling ``ext_hook``; ``max_ext_len=0`` refuses it, and every
    other ext with a payload, before that."""
    return msgpack.unpackb(data, raw=False, strict_map_key=True, ext_hook=_refuse_ext, max_ext_len=0)


def send_msg(sock: socket.socket, obj: dict) -> None:
    payload = packb(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed connection")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> dict:
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return unpackb(_recv_exact(sock, length))


def encode_rows(row_start: int, rows: np.ndarray, allow_compress: bool = True) -> dict:
    """A ``rows_ready`` frame: the row block as raw float32 bytes and its
    shape, zlib-deflated when that shrinks it. ``allow_compress`` is the
    capability gate: deflate only for a peer that advertised ``zlib-rows``."""
    rows = np.ascontiguousarray(rows, np.float32)
    raw = rows.tobytes()
    msg = {"type": "rows_ready", "row_start": int(row_start), "shape": list(rows.shape)}
    if allow_compress:
        packed = zlib.compress(raw, 1)
        if len(packed) < len(raw):
            msg["enc"] = "zlib"
            msg["data"] = packed
            return msg
    msg["data"] = raw
    return msg


def decode_rows(msg: dict) -> np.ndarray:
    data = msg["data"]
    if msg.get("enc") == "zlib":
        data = zlib.decompress(data)
    return np.frombuffer(data, np.float32).reshape(msg["shape"]).copy()
