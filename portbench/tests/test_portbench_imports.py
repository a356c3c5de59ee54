"""Nothing under portbench imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
references import nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_v3_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "yolo_v3_tpu_torch" not in set(top_level_imports(path))


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    from portbench import core

    for name in ("yolo_v3_tpu_torch_like", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "yolo_v3_tpu", types.ModuleType("yolo_v3_tpu"))
    assert core.forbidden_modules() == ["jax.numpy", "yolo_v3_tpu"]
