"""API parity of the port with the JAX package, by an AST scan (neither
package is imported, as in tests/test_torch_imports.py).

For every module of convnets_tpu, the same module of convnets_tpu_torch
must have each public top-level name (a def, a class, an assignment; in a
package's __init__.py also each imported name), each public method of
each class (those inherited from the port's own classes included) and
each argument name of those functions and methods. The exceptions are the
decisions listed below, each with its reason; an exception that no longer
matches a divergence fails too, so the list stays exact.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "convnets_tpu")
PORT_PKG = os.path.join(ROOT, "convnets_tpu_torch")

# modules of the JAX package with no counterpart, by decision
DECIDED_MODULES = {
    "core/aot.py": "ahead-of-time XLA executables for TPU; the port builds its kernels with nvcc",
    "ops/pallas/__init__.py": "Pallas TPU kernels: ported as ops/kernels/ and csrc/*.cu",
    "ops/pallas/block.py": "Pallas TPU kernel: ported as ops/kernels/block.py, csrc/block*.cu",
    "ops/pallas/conv.py": "Pallas TPU kernels: ported as ops/kernels/conv.py, csrc/conv*.cu",
    "ops/pallas/fused.py": "Pallas TPU kernel: ported as ops/kernels/fused.py, bn_act.py",
    "ops/pallas/pool.py": "Pallas TPU kernels: ported as ops/kernels/pool.py, csrc/pool.cu",
    "ops/pallas/routing.py": "the per-shape Pallas-vs-XLA routing table of the TPU",
}
# the JAX functional plumbing that torch modules replace: any method of
# this name, any argument of these names
DECIDED_METHODS = {
    "apply": "the functional apply(variables, x, train, rng): a torch module's forward",
    "children": "torch.nn.Module.children() (inherited) iterates the same child modules; "
                "summarize walks summary_children(), the JAX method's name-keyed dict",
}
DECIDED_ARGS = {
    "key": "a JAX PRNG key: the port draws from torch.Generator streams (core/rng.py)",
    "variables": "the JAX {params, state} tree: a torch model holds its own tensors",
    "sharding": "a JAX sharding: the port's data parallel is a DeviceMesh of processes",
    "platforms": "XLA lowering platforms of a jax.export artifact",
}
# single names: "module:name", "module:Class.method", "module:function(arg)"
DECIDED = {
    "nn/module.py:split_key": "derives a child's JAX key; the port has no keys to split",
    "nn/__init__.py:split_key": "re-exported: see nn/module.py:split_key",
    "core/__init__.py:RngStream": "re-exported: see core/rng.py:RngStream",
    "core/rng.py:key_for": "a JAX key per stream; the port's is core/rng.py:generator_for",
    "core/rng.py:RngStream": "splits a JAX key; the port draws from torch.Generator streams",
    "core/rng.py:hw_dropout_key": "the TPU's hardware PRNG for dropout masks",
    "core/rng.py:use_hw_dropout": "the TPU's hardware PRNG for dropout masks",
    "core/precision.py:Policy.cast_to_compute": "casting a pytree: the port casts with .to()",
    "core/precision.py:Policy.cast_to_param": "casting a pytree: the port casts with .to()",
    "core/precision.py:Policy.cast_to_output": "casting a pytree: the port casts with .to()",
    "train/state.py:variables_of": "the pytree state plumbing: modules hold their tensors",
    "train/state.py:merge_state": "the pytree state plumbing: BN writes its buffers in place",
    "train/state.py:replicate_scalar": "the pytree state plumbing: a jax.Array replicated "
                                       "over a mesh",
    "serve/export.py:ServingModel.__init__(exported)": "wraps a jax.export.Exported; the port's "
                                                       "counterpart is ServingModel.from_program",
    "serve/export.py:ServingModel.__init__(meta)": "see ServingModel.from_program(program, meta)",
}


def _rel(path, pkg):
    return os.path.relpath(path, pkg).replace(os.sep, "/")


def _modules(pkg):
    return sorted(_rel(p, pkg) for p in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True))


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)


def _args(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
    return [n for n in names if n not in ("self", "cls") and not n.startswith("_")]


def _dotted(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return ""


def _public(name):
    return not name.startswith("_") or name == "__init__"


def _scan(path, init):
    """{name: ("def", args) | ("class", {method: args}, bases) | ("name",)}."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    out, lazy = {}, False
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _args(node))
            lazy |= node.name == "__getattr__"
        elif isinstance(node, ast.ClassDef):
            methods = {b.name: _args(b) for b in node.body
                       if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(b.name)}
            out[node.name] = ("class", methods, [_dotted(b) for b in node.bases])
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ("name",)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and init:
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = ("name",)
    if lazy:  # a module __getattr__ (PEP 562) provides the names of __all__
        for node in tree.body:
            if (isinstance(node, ast.Assign) and any(_dotted(t) == "__all__" for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                for elt in node.value.elts:
                    out.setdefault(elt.value, ("name",))
    return out


def _scan_port_imports(path):
    """The names any port module imports at top level (they are attributes
    of the module too)."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(alias.asname or alias.name.split(".")[0] for alias in node.names)
    return names


def _port_classes():
    classes = {}
    for rel in PORT_MODULES:
        for name, entry in _scan(os.path.join(PORT_PKG, rel), rel.endswith("__init__.py")).items():
            if entry[0] == "class":
                classes.setdefault(name, []).append((rel, entry))
    return classes


PORT_CLASSES = _port_classes()


def _port_methods(rel, name, entry, seen=()):
    """The methods of a port class with their arguments, its bases' (found
    by name among the port's classes) included."""
    methods = {}
    for base in entry[2]:
        short = base.split(".")[-1]
        found = [c for c in PORT_CLASSES.get(short, ()) if c[0] == rel] or PORT_CLASSES.get(short, [])
        if len(found) == 1 and short not in seen:
            methods.update(_port_methods(found[0][0], short, found[0][1], seen + (name,)))
    methods.update(entry[1])
    return methods


def _divergences(rel):
    """[(key, what)] of the JAX module `rel` against its port."""
    init = rel.endswith("__init__.py")
    jax_names = _scan(os.path.join(JAX_PKG, rel), init)
    port_path = os.path.join(PORT_PKG, rel)
    port_names = _scan(port_path, init)
    imported = _scan_port_imports(port_path)
    out = []
    for name, entry in jax_names.items():
        if not _public(name) or name == "__init__":
            continue
        if name not in port_names and name not in imported:
            out.append((f"{rel}:{name}", f"{entry[0]} {name} is missing"))
            continue
        port = port_names.get(name, ("name",))
        if entry[0] == "def" and port[0] == "def":
            out += [(f"{rel}:{name}({a})", f"argument {a} of {name} is missing")
                    for a in entry[1] if a not in port[1]]
        if entry[0] == "class" and port[0] == "class":
            methods = _port_methods(rel, name, port)
            for method, args in entry[1].items():
                if method not in methods:
                    out.append((f"{rel}:{name}.{method}", f"method {name}.{method} is missing"))
                else:
                    out += [(f"{rel}:{name}.{method}({a})",
                             f"argument {a} of {name}.{method} is missing")
                            for a in args if a not in methods[method]]
    return out


def _decided(key):
    if key in DECIDED:
        return DECIDED[key]
    if key.endswith(")"):
        return DECIDED_ARGS.get(key[key.rindex("(") + 1:-1])
    return DECIDED_METHODS.get(key.rsplit(".", 1)[-1]) if "." in key.split(":")[1] else None


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in DECIDED_MODULES])
def test_port_module_has_the_jax_api(rel):
    assert rel in PORT_MODULES, f"convnets_tpu_torch/{rel} is missing"
    left = [f"{key}: {what}" for key, what in _divergences(rel) if _decided(key) is None]
    assert not left, "\n".join(left)


def test_decided_modules_are_not_ported():
    for rel, reason in DECIDED_MODULES.items():
        assert reason and rel in JAX_MODULES and rel not in PORT_MODULES, rel


def test_every_decision_is_used():
    """Each exception still matches a divergence (a stale one fails)."""
    keys = [key for rel in JAX_MODULES if rel not in DECIDED_MODULES and rel in PORT_MODULES
            for key, _ in _divergences(rel)]
    assert set(DECIDED) <= set(keys), sorted(set(DECIDED) - set(keys))
    for arg in DECIDED_ARGS:
        assert any(k.endswith(f"({arg})") for k in keys), arg
    for method in DECIDED_METHODS:
        assert any(k.endswith(f".{method}") for k in keys), method


def test_scan_sees_a_divergence():
    """The scan itself: a name, a method and an argument the port lacks on
    purpose are found (so an empty list means parity, not a blind scan)."""
    keys = {key for key, _ in _divergences("core/rng.py")}
    assert "core/rng.py:key_for" in keys
    keys = {key for key, _ in _divergences("nn/layers.py")}
    assert "nn/layers.py:Conv2d.apply" in keys and "nn/layers.py:Conv2d.init(key)" in keys
    # MaxPool2d's __init__ and out_shape are inherited from the port's _Pool2d
    assert {k for k in keys if k.startswith("nn/layers.py:MaxPool2d")} == {
        "nn/layers.py:MaxPool2d.apply"}
