"""Nothing under h100_bench imports JAX or the JAX package (by whole top-level
name: the port's name begins with the JAX package's), the reference imports
nothing of the program, and nothing reads the JAX package's bench files."""

import ast
import glob
import os

import pytest

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "convnets_tpu"}
FILES = sorted(glob.glob(os.path.join(run.HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_walks_every_module():
    assert len(FILES) > 20
    assert any(f.endswith(os.path.join("reference", "resnet.py")) for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=os.path.basename)
def test_reference_takes_nothing_of_the_program(path):
    assert "convnets_tpu_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "tests" + os.sep not in f],
                         ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_bench_files_read(path):
    with open(path) as f:
        text = f.read()
    assert "bench.py" not in text and "BENCH_" not in text


def test_the_check_compares_whole_names():
    import sys
    assert "convnets_tpu_torch" not in FORBIDDEN
    assert run.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
