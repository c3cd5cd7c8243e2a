"""Length-prefixed msgpack framing for the master↔node link
(``flux_tpu/wire.py``).

The reference streams CBOR values over raw TCP (workers.rs:8-10,126-159,
flux-node/src/main.rs:10-12). As in ``flux_tpu``, each frame is a 4-byte
big-endian length followed by one msgpack map, and row blocks travel as raw
float32 bytes and a shape, zlib-deflated where the peer advertised the
``zlib-rows`` capability.

The msgpack codec is the package's own (:func:`packb`, :func:`unpackb`), for
the types the protocol sends: dict, list or tuple, str, bytes, int, float,
bool and None. It writes the bytes that ``msgpack.packb(obj,
use_bin_type=True)`` writes (the smallest form of each int, str and
container length; floats as float64) and reads what that writes as
``msgpack.unpackb(data, raw=False)`` does, so the frames of either package
are the other's. It has one code path, whether ``msgpack`` is installed or
not.
"""

from __future__ import annotations

import socket
import struct
import zlib

import numpy as np

__all__ = ["send_msg", "recv_msg", "encode_rows", "decode_rows", "packb", "unpackb"]

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _pack_len(out: bytearray, n: int, fix_tag: int, fix_max: int, tags, what: str) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    the 8-, 16- and 32-bit forms (``tags``; None where there is none) that
    holds ``n``."""
    if n <= fix_max:
        out.append(fix_tag | n)
    elif tags[0] is not None and n <= 0xFF:
        out += bytes((tags[0], n))
    elif n <= 0xFFFF:
        out.append(tags[1])
        out += _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out.append(tags[2])
        out += _I.pack(n)
    else:
        raise ValueError(f"{what} too large for msgpack: {n}")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += _b.pack(v)
    elif 0x80 <= v <= 0xFF:
        out.append(0xCC)
        out.append(v)
    elif -0x80 <= v < 0:
        out.append(0xD0)
        out += _b.pack(v)
    elif 0xFF < v <= 0xFFFF:
        out.append(0xCD)
        out += _H.pack(v)
    elif -0x8000 <= v < -0x80:
        out.append(0xD1)
        out += _h.pack(v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(0xCE)
        out += _I.pack(v)
    elif -0x80000000 <= v < -0x8000:
        out.append(0xD2)
        out += _i.pack(v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += _Q.pack(v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(0xD3)
        out += _q.pack(v)
    else:
        raise OverflowError(f"int too large for msgpack: {v}")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _d.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6), "bytes")
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD), "array")
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF), "map")
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """The msgpack bytes of ``obj`` (those of ``msgpack.packb(obj,
    use_bin_type=True)``)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# Fixed-width scalars: tag -> (struct, size).
_SCALARS = {
    0xCA: _f, 0xCB: _d,
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
}
# Length-prefixed forms: tag -> (kind, struct of the length).
_SIZED = {
    0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
    0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
    0xDC: ("array", _H), 0xDD: ("array", _I),
    0xDE: ("map", _H), 0xDF: ("map", _I),
}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data truncated")
        view = self.buf[self.pos : end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def read(self):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag == 0xC0:
            return None
        if tag == 0xC2:
            return False
        if tag == 0xC3:
            return True
        if tag in _SCALARS:
            return self.unpack(_SCALARS[tag])
        if tag in _SIZED:
            kind, st = _SIZED[tag]
            n = self.unpack(st)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        raise ValueError(f"unsupported msgpack type 0x{tag:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.read()
        return out


def unpackb(data) -> object:
    """Decode one msgpack value, as ``msgpack.unpackb(data, raw=False)``
    does: str as str, bin as bytes, arrays as lists; map keys must be str
    or bytes; trailing bytes are an error."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack value")
    return obj


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
