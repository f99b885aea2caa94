"""Read the msgpack parameter files of the JAX package without JAX, flax or
the ``msgpack`` package.

Counterpart of ``load_params`` in ``hsimae_tpu/checkpoints/io.py``, which
restores what ``save_params`` / ``save_checkpoint`` wrote with
``flax.serialization``. This is a decoder of the msgpack subset flax emits
(big-endian throughout):

* nil, bool, the int and float families, str, bin, array and map;
* ext type 1, an ndarray, whose payload is itself msgpack ``(shape, dtype
  name, C-order bytes)``; ext type 3, a numpy scalar in the same encoding;
  ext type 2, a Python complex as msgpack ``(real, imag)``;
* a leaf too large for one msgpack object, written as a map with
  ``__msgpack_chunked_array__``, ``shape`` and ``chunks`` (both maps keyed
  ``"0", "1", ...``), joined back into one array.

numpy has no bfloat16: such a leaf is read as uint16 and returned as a
``torch.bfloat16`` tensor. Every other leaf is a numpy array or scalar.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over msgpack bytes; ``value()`` decodes the next object."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return str(self.take(self.unpack(_STR[b])), "utf-8")
        if b in _ARRAY:
            return self.array(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            n = _FIXEXT[b]
        elif b in _EXT:
            n = self.unpack(_EXT[b])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(payload: memoryview):
    """flax's ndarray encoding: msgpack ``(shape, dtype name, raw bytes)``."""
    shape, name, raw = _Reader(payload).value()
    shape = tuple(shape)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).value()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(d: dict):
    def ordered(m: dict) -> Tuple:
        return tuple(m[str(i)] for i in range(len(m)))

    chunks = ordered(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        flat = torch.cat([c.reshape(-1) for c in chunks])
    else:
        flat = np.concatenate(chunks)
    return flat.reshape(ordered(d["shape"]))


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """msgpack bytes written by ``flax.serialization.msgpack_serialize`` ->
    the nested dict of leaves, chunked leaves joined."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return _unchunk_tree(tree)


def load_params(path: str):
    """A parameter tree (or a whole checkpoint) saved by the JAX package's
    ``save_params`` / ``save_checkpoint``, as nested dicts."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
