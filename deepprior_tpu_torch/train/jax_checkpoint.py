"""A reader for the JAX package's checkpoint file, in Python and numpy.

deepprior_tpu/train/checkpoint.py writes

    b"DPTPU1\\x00" | fingerprint length (8 LE) | fingerprint JSON
                   | flax.serialization.to_bytes(tree)

where the tree is msgpack: maps with str keys, and flax's ext types for
the leaves (``flax.serialization._MsgpackExtType``): 1 an ndarray and 3 a
numpy scalar, each a nested msgpack array (shape, dtype name, C-order
bytes), and 2 a Python complex (a nested msgpack (real, imag)).  An array
of more than ``flax.serialization.MAX_CHUNK_SIZE`` bytes is stored as a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
whose tuples are maps of "0", "1", ... keys.

The JAX training mains write network_prior.ckpt and net_<prefix>.ckpt in
it; a machine with the card has neither jax nor the ``msgpack`` package,
so this module decodes the format itself.  A 'bfloat16' leaf, which numpy
cannot hold, is read through ``torch.frombuffer`` and returned widened to
float32 (exact).  Any other msgpack type or ext code raises, naming it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAGIC = b"DPTPU1\x00"
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """msgpack values off a byte buffer, one at a time."""

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = memoryview(buf), pos

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack stream: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (t - 0xC7))
            return self.ext(n)
        if t == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= t <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:  # int 8/16/32/64
            return int.from_bytes(self.take(1 << (t - 0xD0)), "big", signed=True)
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.uint(1 << (t - 0xD9))), "utf-8")
        if t in (0xDC, 0xDD):
            return self.array(self.uint(2 if t == 0xDC else 4))
        if t in (0xDE, 0xDF):
            return self.map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"unknown msgpack type byte 0x{t:02x} at offset {self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _whole(data)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code} (flax writes 1 ndarray, "
                         f"2 complex, 3 numpy scalar)")


def _whole(data) -> Any:
    """One msgpack value that fills ``data``."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after a msgpack value")
    return value


def _ndarray(data) -> np.ndarray:
    shape, dtype, raw = _whole(data)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).float().numpy()
    else:
        flat = np.frombuffer(raw, dtype=np.dtype(dtype)).copy()
    return flat.reshape(shape)


def _tuple(d: dict) -> tuple:
    """A tuple flax stored as a map of "0", "1", ... keys."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree) -> Any:
    """The tree with every chunked-array map joined back into its array."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        return np.concatenate(_tuple(tree["chunks"])).reshape(_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def decode_tree(blob) -> Any:
    """``flax.serialization.msgpack_restore`` without msgpack: the tree of
    dicts and numpy leaves of one msgpack value that fills ``blob``."""
    return _unchunk(_whole(blob))


def is_jax_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(MAGIC)) == MAGIC


def read_jax_checkpoint(path: str) -> Tuple[str, Any]:
    """(the fingerprint JSON, the tree of numpy arrays) of a file the JAX
    package's ``save_checkpoint`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path} is not a deepprior_tpu (JAX package) checkpoint")
    head = _Reader(data, len(MAGIC))
    n = int.from_bytes(head.take(8), "little")
    fingerprint = str(head.take(n), "utf-8")
    return fingerprint, decode_tree(memoryview(data)[head.pos:])
