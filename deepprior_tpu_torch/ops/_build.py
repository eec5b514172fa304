"""Build the package's native sources, load them with ctypes, and launch
the CUDA kernels.

Each CUDA source under ``csrc/`` compiles with nvcc on first use into a
shared library with a plain C interface, in ``deepprior_tpu_torch/_build/``
(``load_library``); each host C++ source under ``cpp/`` (the capture shim)
the same way with g++ (``host_library_path``).  The file name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds and an unchanged one loads at once.
A build writes a temporary file of its own and renames it into place, so
concurrent builds and loaders never see half a library; a failed build
raises.  Nothing builds at import.

``bind`` declares a CUDA library's C functions from its wrapper's
signature table, and ``launch`` calls one on the current stream, so a
kernel's wrapper (``ops/hopper_*.py``) holds only its table and its own
checks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
CPP = os.path.join(_PKG, "cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

# no --use_fast_math and no -prec-div=false: the crop's bit-exactness rests
# on IEEE float32 division
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# the host shim's flags (deepprior_tpu/cpp/CMakeLists.txt builds the JAX
# package's copy the same way)
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# the C types of the kernels' signature tables (``bind``): pointers and the
# stream as c_void_p, since as c_int they would be cut to 32 bits
PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

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


def _build(source: str, path: str, lib: str, compiler: list, flags, libs=()) -> str:
    """Compile ``path`` into ``lib`` unless it is there: into a temporary
    file of its own, renamed into place (atomic: a concurrent
    loader never sees half a file).  Raises RuntimeError naming the
    compiler's output when the build fails."""
    if os.path.exists(lib):
        return lib
    build_dir = os.path.dirname(lib)
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(lib) + ".", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    cmd = [*compiler, *flags, "-o", tmp, path, *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed ({proc.returncode}) building {path}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with nvcc (once per content hash) and load it."""
    digest = source_digest(source)
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")
    return ctypes.CDLL(_build(source, os.path.join(CSRC, source), lib, [find_nvcc()],
                              NVCC_FLAGS))


def bind(source: str, signatures: dict, constants: tuple = ()):
    """The loader of csrc/<source>'s library: a function that, on its first
    call, builds and loads it (``load_library``), declares each C function
    of ``signatures`` ({name: (argtypes, restype)}, the stream last) and
    ``dp_error_string``, and checks the source's compile-time ``constants``
    ((name, value) pairs, read as ``dp_constant(0)``, ``dp_constant(1)``,
    ...) against the wrapper's, raising RuntimeError where they differ;
    later calls return the same library (``cache_clear`` forgets it).  Its
    ``pointers`` attribute holds, for each function, the positions of its
    pointer arguments before the stream, which ``launch`` reads."""
    table = {**signatures, "dp_error_string": ([I32], ctypes.c_char_p)}
    if constants:
        table["dp_constant"] = ([I32], I32)

    @functools.lru_cache(maxsize=None)
    def build() -> ctypes.CDLL:
        lib = load_library(source)
        for name, (argtypes, restype) in table.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        got = tuple(lib.dp_constant(i) for i in range(len(constants)))
        want = tuple(value for _, value in constants)
        if got != want:
            names = ", ".join(name for name, _ in constants)
            raise RuntimeError(f"csrc/{source} has ({names}) {got}, this wrapper {want}")
        return lib

    build.pointers = {name: tuple(i for i, t in enumerate(argtypes[:-1]) if t is PTR)
                      for name, (argtypes, _) in signatures.items()}
    return build


def launch(build, name: str, kernel: str, *args) -> None:
    """Call the C function ``name`` of ``build()``'s library (``bind``) with
    ``args`` in its order, the current CUDA stream last: a tensor (or None)
    at each pointer position of its signature, passed as its data pointer,
    and the scalars as they are.  Every tensor must be contiguous and on one
    CUDA device, else ValueError before the library loads; a non-zero
    return raises RuntimeError with the library's ``dp_error_string``."""
    cargs = list(args)
    dev = None
    for i in build.pointers[name]:
        t = cargs[i]
        if t is None:
            continue
        if dev is None:
            dev = t.device
        if t.device != dev or not t.is_contiguous():
            raise _refusal(kernel, args)
        cargs[i] = t.data_ptr()
    if dev.type != "cuda":
        raise _refusal(kernel, args)
    lib = build()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {lib.dp_error_string(err).decode()}")


def _refusal(kernel: str, args) -> ValueError:
    """What ``launch`` raises for tensors that are not all contiguous on
    one CUDA device (the check runs once per launch; this, only on a
    refusal)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(t.is_contiguous() for t in tensors):
        return ValueError(f"{kernel} needs contiguous tensors")
    return ValueError(f"{kernel} needs every tensor on one CUDA device, got "
                      f"{sorted({str(t.device) for t in tensors})}")


@functools.lru_cache(maxsize=None)
def host_library_path(source: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``cpp/<source>`` with g++ (once per content hash) into
    ``build_dir`` and return the library's path (``realtime/camera.py``
    loads it with ctypes)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the capture shim cpp/capture.cpp needs it")
    path = os.path.join(CPP, source)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    lib = os.path.join(build_dir, f"lib{stem}-{digest[:16]}.so")
    return _build(source, path, lib, [gxx], HOST_FLAGS, ("-lpthread",))
