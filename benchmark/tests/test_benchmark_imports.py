"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program either: top-level module names,
compared whole (bfqzip_tpu_torch begins with bfqzip_tpu)."""

import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "bfqzip_tpu"}


def _sources(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_plain(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"bfqzip_tpu_torch"})


def test_scan_sees_whole_names(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import bfqzip_tpu_torch.engine\nfrom bfqzip_tpu.ops import scan\n")
    assert top_level_imports(str(src)) == {"bfqzip_tpu_torch", "bfqzip_tpu"}
