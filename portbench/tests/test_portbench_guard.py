"""The benchmark measures the PyTorch port alone: no module of it imports
JAX or the JAX package, and the yardstick (references, traffic, counts)
imports nothing of the program either.  Names are compared whole by their
top-level part, so ``speech2lip_tpu_torch`` is not ``speech2lip_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "speech2lip_tpu"}
YARDSTICK = ("reference", "traffic", "counts")


def _modules():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    """Top-level names of every import in the file, nested ones too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = set(_imports(path)) & NEVER
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in _modules() if p.relative_to(HERE).parts[0]
             in YARDSTICK], ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_takes_nothing_of_the_program(path):
    bad = set(_imports(path)) & (NEVER | {"speech2lip_tpu_torch"})
    assert not bad, f"{path} imports {bad}"


def test_guard_compares_whole_names(tmp_path):
    """A module named like the port passes; the JAX package does not."""
    ok = tmp_path / "ok.py"
    ok.write_text("import speech2lip_tpu_torch.infer\n")
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from speech2lip_tpu.ops import nn\n")
    assert not set(_imports(ok)) & NEVER
    assert set(_imports(bad)) & NEVER == {"speech2lip_tpu"}
