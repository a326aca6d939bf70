"""Nothing under perfbench/ loads JAX or the JAX package, and the
reference loads nothing of the program; top-level names compared whole
(the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
import types

import pytest

from perfbench import harness

PKG = harness.HERE


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_sources_import_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "mfcc_tpu_torch" not in set(_imports(path)), path


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_forbidden_module():
    loaded = _loaded_after(
        "from perfbench import harness, calibrate\n"
        "from perfbench.tests.hostdev import Host, tiny_cell\n"
        "for m in harness.load_cell('mfcc13.libri_sorted').metrics['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "harness.run(tiny_cell('fbank80d.libri_sorted'), 5, 0.05, True, Host())")
    assert "mfcc_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference.features")
    assert "mfcc_tpu_torch" not in loaded and "torch" in loaded


def test_the_run_refuses_a_loaded_jax(monkeypatch):
    from perfbench.tests.hostdev import Host, tiny_cell
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mfcc_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        harness.run(tiny_cell("mfcc13.libri_sorted"), 5, 0.01, False, Host())
