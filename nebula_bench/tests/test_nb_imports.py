"""Nothing the benchmark runs loads JAX or the JAX package (`repro`),
judged by whole top-level module names: the port's `repro_torch` begins
with `repro` and is allowed."""

import ast
import subprocess
import sys
import textwrap

from conftest import ROOT

from nebula_bench import harness as H


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_file_imports_jax_or_repro():
    for path in (ROOT / "nebula_bench").rglob("*.py"):
        assert not top_level_imports(path) & set(H.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "nebula_bench" / "reference").rglob("*.py"):
        assert not top_level_imports(path) & {"repro_torch", *H.FORBIDDEN}, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                    "nebula_bench"):
                assert node.module.startswith("nebula_bench.reference"), path


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import torch
        from pathlib import Path
        from nebula_bench import run as R, harness as H
        R.run_cell(Path({str(tiny_root)!r}), "city24-quest3.walk", 7, 0.5, False,
                   torch.device("cpu"), time.perf_counter())
        print("LOADED", sorted({{m.split('.')[0] for m in sys.modules}}))
        print("FOUND", H.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert "repro_torch" in out.stdout


def test_the_check_names_a_loaded_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert H.forbidden_modules() == ["repro"]
