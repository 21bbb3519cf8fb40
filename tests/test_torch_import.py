"""The PyTorch port imports without jax and without the JAX package
bfqzip_tpu, builds only with nvcc, and sends CPU tensors to the plain scan
without counting a kernel launch."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bfqzip_tpu_torch
from bfqzip_tpu_torch.ops import cuda_scan
from bfqzip_tpu_torch.ops.scan import LocalScanOps
from bfqzip_tpu_torch.utils import cuda_build
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

PKG_DIR = os.path.dirname(os.path.abspath(bfqzip_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = ["bfqzip_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="bfqzip_tpu_torch."):
        names.append(info.name)
    return names


_BLOCKED = ("jax", "jaxlib", "bfqzip_tpu")

_BLOCK_JAX = """
import importlib, sys

BLOCKED = %r

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, BlockJax())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(blocked(m) for m in sys.modules)
print("imported", len(sys.argv) - 1)
""" % (_BLOCKED,)


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert {"bfqzip_tpu_torch.engine", "bfqzip_tpu_torch.external", "bfqzip_tpu_torch.ops.cuda_scan",
            "bfqzip_tpu_torch.utils.cuda_build", "bfqzip_tpu_torch.bench"} <= set(mods)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX, *mods], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


TOOLS = ("profile_stages_torch.py", "profile_build_torch.py", "profile_smooth_torch.py",
         "run_ext10m_torch.py", "bench_extmerge_torch.py", "bench_prims_torch.py",
         "bench_prims2_torch.py", "microbench_sort_torch.py", "exp_unstable_sort_torch.py",
         "exp_overlap_torch.py", "bench_cm_torch.py", "bench_decode_scaling_torch.py")


def test_tools_import_with_jax_blocked():
    mods = [t.removesuffix(".py") for t in TOOLS]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tools")]))
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX, *mods], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")] + [os.path.join(REPO, "tools", t) for t in TOOLS]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, f) for f in names if f.endswith((".py", ".cu"))]
    return files


def _import_pattern(package: str):
    """A line that imports `package` or a module inside it
    (bfqzip_tpu_torch is another name and does not match bfqzip_tpu)."""
    return re.compile(rf"^\s*(import|from)\s+{package}([\s.,]|$)", re.M)


def _importers(package: str) -> list:
    pattern = _import_pattern(package)
    return [f for f in _sources() if pattern.search(open(f).read())]


def test_no_jax_import_in_package_or_smoke():
    assert not _importers("jax")


def test_no_jax_package_import_in_port_or_smoke():
    assert not _importers("bfqzip_tpu")


def test_import_scan_catches_a_jax_package_import():
    pattern = _import_pattern("bfqzip_tpu")
    assert pattern.search("    from bfqzip_tpu.io.spill import Spill\n")
    assert pattern.search("import bfqzip_tpu\n")
    assert not pattern.search("from bfqzip_tpu_torch.io.spill import Spill\n")


def test_build_raises_without_nvcc(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "library_path", lambda *a, **k: "/nonexistent/seg_scan.so")
    with pytest.raises(cuda_build.CudaBuildError, match="nvcc not found"):
        cuda_build.load("seg_scan")


def test_cpu_scans_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(cuda_scan, "launches", 0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 100, 5000, dtype=np.int32))
    x5 = torch.as_tensor(rng.integers(0, 100, (5, 5000), dtype=np.int32))
    f = torch.as_tensor(rng.random(5000) < 0.01)
    ops = LocalScanOps()
    ops.cummax(x)
    ops.seg_cumsum(x5, f)
    ops.seg_cummax(x, f)
    ops.seg_cumor(x, f)
    ops.next_marked(x, f)
    ops.seg_scan(x.to(torch.float64), f, "add", 0.0)
    assert cuda_scan.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.seg_scan(x, torch.zeros(10, dtype=torch.bool), "add", 0)
    assert cuda_scan.launches == 0


def test_cuda_device_without_card_raises(monkeypatch):
    from bfqzip_tpu_torch.engine import resolve_device, smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    batch = ReadBatch(seqs=np.ones((1, 3), np.uint8), quals=np.full((1, 3), 40, np.uint8),
                      lengths=np.array([3], np.int32))
    with pytest.raises(RuntimeError, match="cuda"):
        smooth_fastq(batch)
    assert resolve_device("cpu") == torch.device("cpu")
