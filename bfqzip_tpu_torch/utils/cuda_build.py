"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
into `<repo>/build/bfqzip_tpu_torch/<name>-<hash>.so`, where the hash covers
the source bytes and the compiler flags, so an edited source rebuilds and an
unchanged one loads the existing library.  The result is loaded with ctypes;
callers declare argtypes with `ctypes.c_void_p` for every pointer and for the
stream.  A missing nvcc or a failed compile raises with the compiler's
output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
# nvcc is looked up on PATH, then in the toolkit's default location
_NVCC_SEARCH = "/usr/local/cuda/bin"

_LOADED: dict[str, ctypes.CDLL] = {}


class CudaBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    path = os.pathsep.join(p for p in (os.environ.get("PATH", ""), _NVCC_SEARCH) if p)
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise CudaBuildError(
            f"nvcc not found on PATH or in {_NVCC_SEARCH}: the CUDA kernels of "
            "bfqzip_tpu_torch need the CUDA toolkit to build"
        )
    return nvcc


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu unless its library exists; returns (path, log)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise CudaBuildError(
                f"nvcc failed ({proc.returncode}) on {name}.cu:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _LOADED[name] = ctypes.CDLL(path)
    return lib
