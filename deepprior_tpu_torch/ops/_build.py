"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles on first use into a shared library
with a plain C interface, in ``deepprior_tpu_torch/_build/``.  The file
name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged
one loads at once.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# no --use_fast_math and no -prec-div=false: the crop's bit-exactness rests
# on IEEE float32 division
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# what the last build of each source printed (nvcc -Xptxas -v reports each
# kernel's registers, shared memory and spills)
BUILD_LOG: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else under $CUDA_HOME or /usr/local/cuda."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit"
    )


def source_digest(source: str, csrc: str = CSRC) -> str:
    """The hash a build of ``csrc/<source>`` is keyed on: the source, every
    shared header (``*.cuh``) and the flags."""
    with open(os.path.join(csrc, source), "rb") as f:
        text = f.read()
    for header in sorted(n for n in os.listdir(csrc) if n.endswith(".cuh")):
        with open(os.path.join(csrc, header), "rb") as f:
            text += f.read()
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    path = os.path.join(CSRC, source)
    digest = source_digest(source)
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.tmp.{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, path]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {path}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(lib)
