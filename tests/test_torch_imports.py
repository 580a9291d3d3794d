"""Import hygiene of the port, by an AST scan (not by importing it: a test
process may already have jax loaded).

convnets_tpu_torch must never import jax, nor anything of convnets_tpu,
not even a module there that does not import jax: the port keeps its own
copies (settings.py, core/shapes.py, data/, train/scheduler.py, ...).
chip_smoke.py, which runs where jax is absent, imports neither.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "convnets_tpu_torch", "**", "*.py"),
                              recursive=True))
ALLOWED_FROM_JAX_PACKAGE = set()


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _top(name):
    return name.split(".")[0]


def test_the_port_has_modules_to_scan():
    names = {os.path.relpath(p, ROOT) for p in PORT_FILES}
    for module in ("ops/kernels/__init__.py", "ops/kernels/block.py", "models/resnext.py",
                   "settings.py", "data/loader.py", "train/scheduler.py"):
        assert f"convnets_tpu_torch/{module}" in names
    assert len(names) >= 15


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports(path):
    for name in _imported_modules(path):
        assert _top(name) not in ("jax", "jaxlib", "flax", "optax"), f"{path}: imports {name}"
        if _top(name) == "convnets_tpu":
            assert any(name == a or name.startswith(a + ".") for a in ALLOWED_FROM_JAX_PACKAGE), \
                f"{path}: imports {name} from the JAX package"


def test_chip_smoke_imports_nothing_of_jax():
    for name in _imported_modules(os.path.join(ROOT, "chip_smoke.py")):
        assert _top(name) not in ("jax", "jaxlib", "convnets_tpu"), name
