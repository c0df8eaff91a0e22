"""The port stands alone: no module of `src/repro_torch` and not
`chip_smoke.py` imports JAX or the JAX package `repro`."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    bad = []
    for path in FILES:
        for name in _imported(ast.parse(path.read_text(), filename=str(path))):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(FILES) > 30 and not bad, bad


@pytest.mark.parametrize("source,flagged", [
    ("import jax.numpy as jnp", True), ("from jaxlib import xla_client", True),
    ("from repro.core import lod_search", True), ("import repro", True),
    ("from repro_torch.core import lod_search", False), ("import torch", False),
    ("from . import fleet", False)])
def test_guard_flags_reference_imports(source, flagged):
    names = list(_imported(ast.parse(source)))
    assert any(n.split(".")[0] in FORBIDDEN for n in names) == flagged
