"""Build and load the port's CUDA kernels: nvcc into a shared library
with a plain C interface, bound with ctypes.

The sources under ``numbskull_tpu_torch/csrc/`` are compiled at first use
for ``sm_90a`` into ``build/numbskull_tpu_torch/`` at the repository
root (listed in .gitignore). The library's file name carries a hash of
every source under ``csrc/`` (the shared headers included) and the
flags, so an edited source never loads a stale build. Each library has
its own build lock, so two libraries can build at once.
Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

from numbskull_tpu_torch.observability import span

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "..", "csrc")
BUILD_DIR = os.path.join(_HERE, "..", "..", "build", "numbskull_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: outcome of the last build in this process: seconds, library path,
#: and the compiler's resource report (registers, spills per kernel)
BUILD_INFO: dict = {}

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC", ""),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME to build "
                       "the numbskull_tpu_torch CUDA kernels")


def sources_digest() -> str:
    """Hash of every ``csrc/*.cu`` and ``csrc/*.cuh`` file and the nvcc
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            digest.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
                digest.update(fh.read())
    return digest.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu`` as a ctypes library; the
    first call of a process for ``name`` is the span ``kernels.load``."""
    if name in _LIBS:
        return _LIBS[name]
    with span("kernels.load"):
        src = os.path.join(CSRC_DIR, name + ".cu")
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, "lib%s_%s.so"
                                % (name, sources_digest()))
        with open(os.path.join(BUILD_DIR, ".build.%s.lock" % name),
                  "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(lib_path):
                tmp = lib_path + ".tmp%d" % os.getpid()
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed for %s:\n%s%s"
                                       % (src, proc.stdout, proc.stderr))
                os.replace(tmp, lib_path)
                BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                    "path": lib_path,
                                    "ptxas": proc.stdout + proc.stderr}
        lib = ctypes.CDLL(lib_path)
    _LIBS[name] = lib
    return lib
