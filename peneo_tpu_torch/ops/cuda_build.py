"""Build a CUDA source of this package into a shared library with ``nvcc``.

The kernels have a plain C interface and are loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). A library is built at first use
into ``.kernel_build/`` beside the package (git-ignored) and cached by a hash
of its source and flags; a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), ".kernel_build")
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def build_library(source: str) -> str:
    """Path of the built ``.so`` for ``csrc/<source>``; builds it if the
    cached one is missing. nvcc's ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside it as ``<name>.log``."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    name = f"{os.path.splitext(source)[0]}-{digest.hexdigest()[:16]}"
    out = os.path.join(BUILD_DIR, name + ".so")
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}")
        with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
            f.write(res.stderr)
        os.replace(tmp, out)  # atomic: no reader sees half a file
    return out


def build_log(source: str) -> str:
    """The nvcc report of the cached build of ``csrc/<source>``."""
    path = build_library(source)
    with open(path[:-len(".so")] + ".log") as f:
        return f.read()
