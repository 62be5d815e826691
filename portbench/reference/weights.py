"""Frozen reader of the flax msgpack checkpoints under ``portbench/configs``.

A copy of the msgpack decoding of ``stardist_torch/models/weights.py`` at
commit 2f1d91d (``_Reader``, ``msgpack_loads``, ``load_flax_variables``),
kept here so that the reference decodes the weights itself: it reads no
table, weight or code of the program. Numpy only.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def sint(self, n):
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        if t >= 0xE0:
            return t - 0x100
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):                     # bin 8/16/32
            return self.take(self.uint(1 << (t - 0xC4)))
        if t in (0xC7, 0xC8, 0xC9):                     # ext 8/16/32
            n = self.uint(1 << (t - 0xC7))
            return self._ext(self.sint(1), self.take(n))
        if t == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= t <= 0xCF:                           # uint 8..64
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:                           # int 8..64
            return self.sint(1 << (t - 0xD0))
        if 0xD4 <= t <= 0xD8:                           # fixext 1..16
            code = self.sint(1)
            return self._ext(code, self.take(1 << (t - 0xD4)))
        if t in (0xD9, 0xDA, 0xDB):                     # str 8/16/32
            return self.take(self.uint(1 << (t - 0xD9))).decode()
        if t in (0xDC, 0xDD):                           # array 16/32
            return [self.obj() for _ in range(self.uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):                           # map 16/32
            return self._map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, code, payload):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = msgpack_loads(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_loads(data):
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_flax_variables(path):
    """The variable tree of a flax msgpack checkpoint: ``{"params": ...}``
    (nested dicts of numpy arrays)."""
    with open(path, "rb") as f:
        tree = msgpack_loads(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a flax checkpoint with a 'params' entry")
    return tree
