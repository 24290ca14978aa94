"""An account of the JAX package's whole public surface in the port.

For every module of ``src/repro``, the names it defines at top level
(functions, classes, assignments, also under a top-level ``if`` or
``try``), each public method of its classes and each ``__all__`` entry
are read with ``ast``: neither package is imported. Each must have a
counterpart at the same path in ``src/repro_torch`` (bound there at top
level, imported included, or listed in its ``__all__``: a name served by
a module ``__getattr__``), or stand in ``DIFFERENCES`` with the reason it
differs. A second case holds the table itself to the code: each entry
names a public name of the reference, a rename's target exists in the
port, and a name said not to be ported is still absent from it; a name
listed there once and ported since (``PORTED``) is in it.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"

_TILES = ("not ported: a Pallas tile constant of the TPU kernel; the CUDA "
          "kernels set their tiles in csrc/*.cu")
_HLO = ("not ported: XLA's HLO text; the port counts FLOPs and collectives "
        "with a dispatch mode on the meta device (launch/hlo.py)")

# "module:name" (module relative to the package, a package by its
# directory) -> "renamed to <name in the same module>" or
# "not ported: <reason>".
DIFFERENCES = {
    "dist.compat:shard_map": (
        "not ported: the spelling of jax.shard_map across JAX versions; "
        "the port imports no JAX"),
    "launch.hlo:parse_module": _HLO,
    "launch.hlo:Computation": _HLO,
    "launch.hlo:Instruction": _HLO,
    "launch.roofline:tpu_estimate": (
        "not ported: the TPU's roofline; the port's (launch/roofline.py) "
        "holds the H100's constants"),
    "kernels.spmv.kernel:ell_mulsum": "renamed to ell_spmv",
    "kernels.spmv.kernel:ell_onehot_mv": "renamed to ell_onehot",
    "kernels.spmv.kernel:LANES": _TILES,
    "kernels.spmv.kernel:SUBLANES": _TILES,
    "kernels.pack.kernel:LANES": _TILES,
    "kernels.flash_attention.kernel:NEG_INF": (
        "not ported: the Pallas kernel's mask value; the CUDA kernel's "
        "is in csrc/flash_attention.cu, the plain version's is "
        "kernels/flash_attention/ops.py:NEG_INF"),
    "models.attention:KVCache": (
        "not ported: defined in the JAX package and used nowhere"),
    "models.attention:KVCache.zeros": (
        "not ported: a method of KVCache, which the JAX package uses "
        "nowhere"),
    "models.model:LM.init": (
        "not ported: the LM constructor draws the weights from its "
        "torch.Generator (seed=)"),
    "models.params:axes": (
        "not ported: LM.param_axes gives each parameter's axes"),
    "models.params:abstract": (
        "not ported: LM.abstract_params gives the shapes without "
        "allocating"),
}

# Entries of DIFFERENCES since ported under their own name. Each stays
# a case of the reverse check, which now holds it to the port.
PORTED = ("core:jit_runner", "core.executor:jit_runner",
          "spmv.distributed:AXIS", "spmv.distributed:spmv_shard")

_BLOCKS = (ast.If, ast.Try)


def _body(nodes):
    """Top-level statements, also those under a top-level if or try."""
    for node in nodes:
        if isinstance(node, _BLOCKS):
            yield from _body(node.body)
            yield from _body(node.orelse)
            for h in getattr(node, "handlers", ()):
                yield from _body(h.body)
            yield from _body(getattr(node, "finalbody", ()))
        else:
            yield node


def _targets(node) -> list[str]:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _all(node) -> list[str]:
    if "__all__" in _targets(node) and isinstance(
            node.value, (ast.List, ast.Tuple)):
        return [e.value for e in node.value.elts]
    return []


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def reference_names(path: pathlib.Path) -> set[str]:
    """The public names ``path`` defines, its classes' public methods
    (``Class.method``) and its ``__all__``."""
    out: set[str] = set()
    for node in _body(_tree(path).body):
        out.update(_all(node))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)))
        out.update(_targets(node))
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def port_names(path: pathlib.Path) -> set[str]:
    """Every name bound at the top level of ``path`` (imports too), its
    ``__all__``, and each class member as ``Class.member``."""
    out: set[str] = set()
    if not path.exists():
        return out
    for node in _body(_tree(path).body):
        out.update(_all(node))
        out.update(_targets(node))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{m.name}")
                    out.update(f"{node.name}.{t}" for t in _targets(m))
    return out


def module_of(path: pathlib.Path) -> str:
    rel = path.relative_to(REF).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


REFERENCE_MODULES = sorted(REF.rglob("*.py"))


def test_the_walk_sees_the_reference():
    """The walk reads every module and the names the port is known to
    share, so the cases below cannot pass on an empty surface."""
    assert len(REFERENCE_MODULES) >= 90
    spmv = reference_names(REF / "spmv" / "distributed.py")
    assert {"make_distributed_spmv", "spmv_shard", "AXIS"} <= spmv
    core = reference_names(REF / "core" / "__init__.py")
    assert {"algorithm1", "featurize_like", "jit_runner"} <= core
    assert "LM.init" in reference_names(REF / "models" / "model.py")


@pytest.mark.parametrize(
    "path", REFERENCE_MODULES, ids=[module_of(p) or "repro"
                                    for p in REFERENCE_MODULES])
def test_reference_module_has_its_counterpart(path):
    module = module_of(path)
    port = port_names(PORT / path.relative_to(REF))
    missing = [f"{module}:{n}" for n in sorted(reference_names(path))
               if n not in port and f"{module}:{n}" not in DIFFERENCES]
    assert not missing, ("public names of the JAX package with no "
                         f"counterpart in the port: {missing}")


@pytest.mark.parametrize("key", sorted(DIFFERENCES) + list(PORTED))
def test_differences_are_still_differences(key):
    module, name = key.split(":")
    rel = pathlib.Path(*module.split("."))
    ref = REF / rel / "__init__.py" if (REF / rel).is_dir() \
        else REF / rel.with_suffix(".py")
    port = PORT / ref.relative_to(REF)
    assert name in reference_names(ref), f"{key} is not in the JAX package"
    if key in PORTED:
        assert key not in DIFFERENCES and name in port_names(port), (
            f"{key} is not in the port under its own name")
        return
    reason = DIFFERENCES[key]
    if reason.startswith("renamed to "):
        target = reason.removeprefix("renamed to ")
        assert target in port_names(port), f"{key}: no {target} in the port"
    else:
        assert reason.startswith("not ported: ") and len(reason) > 20
    assert name not in port_names(port), (
        f"{key} is now in the port under its own name: take it out of "
        "DIFFERENCES")


def test_each_port_module_imports_first():
    """Every module of the port imports in an interpreter where no other
    module of the port was imported before it: the re-exports close no
    import cycle."""
    code = """
import importlib, pathlib, sys
bad = []
for p in sorted(pathlib.Path(sys.argv[1]).rglob("*.py")):
    mod = ".".join(p.relative_to(pathlib.Path(sys.argv[1]).parent)
                   .with_suffix("").parts).removesuffix(".__init__")
    for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[k]
    try:
        importlib.import_module(mod)
    except Exception as e:
        bad.append(f"{mod}: {e!r}")
    if "jax" in sys.modules or "repro" in sys.modules:
        bad.append(f"{mod} imported JAX or the JAX package")
print(bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(PORT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
