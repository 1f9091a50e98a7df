"""Checkpoint files of the JAX package and of HF, read and written in pure
Python and numpy (no ``flax``, ``msgpack`` or ``safetensors``).

- :func:`read_flax_msgpack` reads what ``flax.serialization.to_bytes``
  writes (``peneo_tpu/pipeline/checkpoint.py:114-120``: ``params.msgpack``;
  ``tools/generate_peneo_weights.py``: ``backbone_params.msgpack``) and
  returns the nested dict ``msgpack_restore`` would: maps, str, bin, arrays,
  nil, bool, int, float and the ext types — code 1 an ndarray (a packed
  ``(shape, dtype name, C-order bytes)`` tuple), code 2 a complex, code 3 a
  numpy scalar. ``bfloat16`` leaves (read as uint16) are widened to fp32
  by a 16-bit shift, which is exact. Leaves over 2³⁰ bytes, which flax
  writes as ``{"__msgpack_chunked_array__": True, "shape": …, "chunks":
  …}``, are put back together.
- :func:`write_flax_msgpack` writes a nested dict of numpy arrays, numpy
  scalars and Python scalars and strings in that format (chunking as flax
  does), so that ``flax.serialization.msgpack_restore`` reads it back.
- :func:`read_safetensors` reads a ``model.safetensors`` (an 8-byte
  little-endian header length, a JSON header of dtypes, shapes and data
  offsets, then the data); BF16 is widened to fp32.

Array leaves are ``np.frombuffer`` views of the file's one (writable)
buffer, never parsed byte by byte in Python.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax's limit for one array leaf, in bytes
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def widen_bfloat16(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns → the fp32 values they stand for."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _read_file(path: str) -> bytearray:
    """The whole file in one writable buffer (so the leaves viewing it are
    writable arrays)."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return buf


# ------------------------------------------------------------------ msgpack
class _Reader:
    """A msgpack decoder over one buffer; bin values are zero-copy
    memoryview slices."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def value(self):
        b = self.take(1)[0]
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
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return self.take(self.unpack(sizes[b - 0xC4]))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, name, data = self.value()
            arr = _ndarray(data, name, shape)
            out = arr if code == EXT_NDARRAY else arr[()]
        elif code == EXT_COMPLEX:
            re, im = self.value()
            out = complex(re, im)
        else:
            raise ValueError(f"unknown msgpack ext type {code}")
        if self.pos != end:
            raise ValueError("malformed msgpack ext payload")
        return out


def _ndarray(data: memoryview, name, shape) -> np.ndarray:
    name = name if isinstance(name, str) else str(name, "utf-8")
    if name == "bfloat16":
        return widen_bfloat16(np.frombuffer(data, np.uint16)).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(path: str) -> Any:
    """A file of ``flax.serialization.to_bytes`` → its nested dict, as
    ``msgpack_restore`` gives it (numpy leaves; bfloat16 as fp32)."""
    reader = _Reader(_read_file(path))
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack value")
    return _unchunk(tree)


def _chunk(arr: np.ndarray) -> Dict:
    """flax's ``_chunk``: a flat array in pieces of at most 2³⁰ bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


class _Writer:
    def __init__(self, write: Callable[[bytes], Any]):
        self.write = write

    def header(self, small_base: int, small_max: int, codes, n: int):
        """A length header: the fix form (``small_base | n``) when it fits,
        else the 8/16/32-bit form (``codes``; None where absent)."""
        if small_base is not None and n <= small_max:
            self.write(bytes([small_base | n]))
            return
        for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                    (0xFF, 0xFFFF, 0xFFFFFFFF)):
            if code is not None and n <= limit:
                self.write(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack length {n} out of range")

    def int(self, v: int):
        if 0 <= v <= 0x7F:
            self.write(bytes([v]))
        elif -32 <= v < 0:
            self.write(struct.pack(">b", v))
        elif v >= 0:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF),
                                     (0xCF, ">Q", 2 ** 64 - 1)):
                if v <= limit:
                    self.write(bytes([code]) + struct.pack(fmt, v))
                    return
            raise ValueError(f"integer {v} out of msgpack's range")
        else:
            for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                     (0xD2, ">i", 2 ** 31),
                                     (0xD3, ">q", 2 ** 63)):
                if v >= -limit:
                    self.write(bytes([code]) + struct.pack(fmt, v))
                    return
            raise ValueError(f"integer {v} out of msgpack's range")

    def str(self, s: str):
        data = s.encode("utf-8")
        self.header(0xA0, 31, (0xD9, 0xDA, 0xDB), len(data))
        self.write(data)

    def ndarray(self, arr: np.ndarray, code: int):
        if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
            arr = arr.copy(order="C")
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError("object and structured dtypes are not "
                             "supported")
        # the payload: msgpack of (shape, dtype name, C-order bytes)
        parts = []
        sub = _Writer(parts.append)
        sub.header(0x90, 15, (None, 0xDC, 0xDD), 3)
        sub.header(0x90, 15, (None, 0xDC, 0xDD), arr.ndim)
        for d in arr.shape:
            sub.int(int(d))
        sub.str(arr.dtype.name)
        sub.header(None, 0, (0xC4, 0xC5, 0xC6), arr.nbytes)
        prefix = b"".join(parts)
        self.header(None, 0, (0xC7, 0xC8, 0xC9), len(prefix) + arr.nbytes)
        self.write(struct.pack(">b", code))
        self.write(prefix)
        self.write(arr.reshape(-1).view(np.uint8).data)

    def value(self, v):
        if isinstance(v, dict):
            self.header(0x80, 15, (None, 0xDE, 0xDF), len(v))
            for k, x in v.items():
                self.str(str(k))
                if (isinstance(x, np.ndarray)
                        and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE):
                    x = _chunk(x)
                self.value(x)
        elif isinstance(v, np.ndarray):
            self.ndarray(v, EXT_NDARRAY)
        elif isinstance(v, np.generic):
            self.ndarray(np.asarray(v), EXT_NPSCALAR)
        elif v is None:
            self.write(b"\xc0")
        elif isinstance(v, bool):
            self.write(b"\xc3" if v else b"\xc2")
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, float):
            self.write(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            self.str(v)
        else:
            raise TypeError(f"cannot write {type(v).__name__} as msgpack")


def write_flax_msgpack(tree: Any, path: str) -> None:
    """Write ``tree`` (nested dicts of numpy arrays, numpy scalars and
    Python scalars and strings) as ``flax.serialization.to_bytes``
    would."""
    with open(path, "wb") as f:
        _Writer(f.write).value(tree)


# -------------------------------------------------------------- safetensors
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
    "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file → {name: numpy array} (BF16 as fp32)."""
    buf = _read_file(path)
    (n,) = struct.unpack_from("<Q", buf, 0)
    header = json.loads(buf[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        dtype = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
        begin, end = info["data_offsets"]
        arr = np.frombuffer(buf, dtype, (end - begin) // dtype.itemsize,
                            base + begin).reshape(info["shape"])
        out[name] = widen_bfloat16(arr) if info["dtype"] == "BF16" else arr
    return out
