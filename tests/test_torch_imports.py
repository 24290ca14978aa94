"""The port stands alone: no module of ``src/repro_torch/`` (nor
``chip_smoke.py``, which drives it on the card, nor the port's examples
``examples/torch_*.py``) imports the JAX package ``repro`` or ``jax``,
at module level or inside a function."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("repro", "jax", "jaxlib")


def imported_modules(tree: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def test_the_walk_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert len(names) > 50
    for must in ("src/repro_torch/obs/telemetry.py",
                 "src/repro_torch/driver/driver.py",
                 "src/repro_torch/search/surrogate.py",
                 "src/repro_torch/rules/boost.py",
                 "src/repro_torch/models/model.py",
                 "src/repro_torch/serve/engine.py",
                 "src/repro_torch/engine/rpc.py",
                 "src/repro_torch/engine/server.py",
                 "src/repro_torch/core/stepdag.py",
                 "src/repro_torch/launch/costs.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/mamba.py",
                 "src/repro_torch/models/rwkv6.py",
                 "examples/torch_schedule_search.py",
                 "examples/torch_serve_lm.py", "chip_smoke.py"):
        assert must in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_module_imports_neither_jax_nor_the_jax_package(path):
    mods = imported_modules(ast.parse(path.read_text(), str(path)))
    assert [m for m in mods if forbidden(m)] == []


def test_the_check_catches_both_forms():
    tree = ast.parse("import os\nfrom repro.core import dag\n"
                     "def f():\n    import jax.numpy as jnp\n"
                     "from repro_torch import obs\nfrom . import x\n")
    assert [m for m in imported_modules(tree) if forbidden(m)] == \
        ["repro.core", "jax.numpy"]
