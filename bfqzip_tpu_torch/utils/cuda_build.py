"""Build the package's C sources at first use and load them through ctypes.

Each `csrc/<name>.cu` (CUDA, compiled with nvcc) or `csrc/<name>.cpp` (host
C++, compiled with the host compiler `c++`) has a plain C interface and is
compiled on first use into `<repo>/build/bfqzip_tpu_torch/<name>-<hash>.so`,
where the hash covers the source bytes, the compiler flags and the host's
architecture, so an edited source rebuilds and an unchanged one loads the
existing library.  The result is loaded with ctypes; callers declare
argtypes with `ctypes.c_void_p` for every pointer and for the stream.  A
missing compiler or a failed compile raises with the compiler's output:
there is no fallback.  Host C++ is built without -march flags, so a library
built on one host loads on another of the same architecture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "bfqzip_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, in the log
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# nvcc is looked up on PATH, then in the toolkit's default location
_NVCC_SEARCH = "/usr/local/cuda/bin"

_LOADED: dict[str, ctypes.CDLL] = {}


class CudaBuildError(RuntimeError):
    """nvcc or the host compiler is missing or refused a source."""


def find_nvcc() -> str:
    path = os.pathsep.join(p for p in (os.environ.get("PATH", ""), _NVCC_SEARCH) if p)
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise CudaBuildError(
            f"nvcc not found on PATH or in {_NVCC_SEARCH}: the CUDA kernels of "
            "bfqzip_tpu_torch need the CUDA toolkit to build"
        )
    return nvcc


def find_cxx() -> str:
    cxx = shutil.which("c++")
    if cxx is None:
        raise CudaBuildError("c++ not found on PATH: the host C++ of bfqzip_tpu_torch needs it to build")
    return cxx


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    """(the source of `name`, its compiler flags)."""
    cpp = os.path.join(CSRC_DIR, f"{name}.cpp")
    if os.path.exists(cpp):
        return cpp, CXX_FLAGS
    return os.path.join(CSRC_DIR, f"{name}.cu"), NVCC_FLAGS


def library_path(name: str) -> str:
    src, flags = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags).encode())
    digest.update(platform.machine().encode())  # an x86-64 build never loads on aarch64
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu or .cpp unless its library exists; returns (path, log)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    src, flags = _source(name)
    compiler = find_cxx() if src.endswith(".cpp") else find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise CudaBuildError(
                f"{os.path.basename(compiler)} failed ({proc.returncode}) on "
                f"{os.path.basename(src)}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .cpp, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _LOADED[name] = ctypes.CDLL(path)
    return lib
