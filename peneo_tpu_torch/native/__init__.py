"""Native (C++) host-side chain-walk decoder, loaded via ctypes.

The port's own copy of ``peneo_tpu/native``: the device ships compact top-k
spot arrays (models/decoder.py); the sequential chain walk over them runs on
the host in ``decode.cpp`` (C ABI). The library is built lazily with ``g++``
into ``.native_build/`` beside the package (git-ignored); without a
toolchain ``pipeline.decode`` uses the pure-python path (identical outputs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         ".native_build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build(src: str, out_dir: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(out_dir, f"libpeneo_decode-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", src, "-o", tmp],
        check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, so)
    return so


def load_decode_lib():
    """ctypes handle to the native decoder, or None when it cannot be built.
    Thread-safe; builds at most once per process."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(_build(os.path.join(_HERE, "decode.cpp"),
                                     BUILD_DIR))
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"native decoder unavailable ({e}); "
                          f"using the python path")
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        f32p = ctypes.POINTER(ctypes.c_float)
        head = [i32p, i32p, i8p, f32p, ctypes.c_int]
        lib.peneo_decode_sample.argtypes = (
            head * 5) + [ctypes.c_float] + [i32p] * 7 + [ctypes.c_int, i32p]
        lib.peneo_decode_sample.restype = ctypes.c_int
        _LIB = lib
        return _LIB
