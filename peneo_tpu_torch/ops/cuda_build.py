"""Build CUDA sources of this package into shared libraries with ``nvcc``.

The kernels have a plain C interface and are loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). A library is built at first use
into ``.kernel_build/`` beside the package (git-ignored) and cached by a hash
of its source, the shared ``csrc/*.cuh`` headers and the flags; a failed
build raises with nvcc's stderr. :func:`build_libraries` starts one nvcc per
missing library, all at once.
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

_BUILD_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _library_path(source: str) -> str:
    """``.kernel_build/<name>-<hash>.so`` of ``csrc/<source>``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header of csrc/ it may include
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [os.path.join(CSRC_DIR, source)] + [
            os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    name = f"{os.path.splitext(source)[0]}-{digest.hexdigest()[:16]}"
    return os.path.join(BUILD_DIR, name + ".so")


def build_libraries(sources) -> list:
    """Paths of the built ``.so`` of each ``csrc/<source>``, in order. The
    missing ones are built at once (one nvcc each, all started together);
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each as ``<name>.log``. Raises with nvcc's report of each build
    that failed, once all have ended."""
    outs = [_library_path(s) for s in sources]
    with _BUILD_LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        builds = []  # [out, tmp, cmd, log, process]
        try:
            for source, out in zip(sources, outs):
                if os.path.exists(out) or any(b[0] == out for b in builds):
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, source)]
                builds.append([out, tmp, cmd,
                               open(out[:-len(".so")] + ".log", "w"), None])
                builds[-1][4] = subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=builds[-1][3])
        finally:  # every nvcc started is waited for, even if another failed
            for b in builds:
                if b[4] is not None:
                    b[4].wait()
                b[3].close()
        failed = []
        for out, tmp, cmd, log, proc in builds:
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: no reader sees half a file
            else:
                with open(log.name) as f:
                    failed.append(f"nvcc failed ({proc.returncode}): "
                                  f"{' '.join(cmd)}\n{f.read()}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build_library(source: str) -> str:
    """Path of the built ``.so`` for ``csrc/<source>``; builds it if the
    cached one is missing."""
    return build_libraries([source])[0]


def build_log(source: str) -> str:
    """The nvcc report of the cached build of ``csrc/<source>``."""
    path = build_library(source)
    with open(path[:-len(".so")] + ".log") as f:
        return f.read()
