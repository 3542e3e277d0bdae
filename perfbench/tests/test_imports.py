"""Nothing the benchmark runs loads JAX or the JAX package; the reference
imports nothing of the program either. Module names are compared by their
top-level part, whole (``tvc_torch`` begins with ``tvc``)."""

import ast
import subprocess
import sys

from perfbench import common


def test_forbidden_names_are_compared_whole():
    assert common.forbidden_loaded({"tvc_torch": 1, "tvc_torch.models": 1, "jaxtyping": 1}) == []
    assert common.forbidden_loaded({"tvc.models.clip": 1, "jax.numpy": 1, "flax": 1}) == ["flax", "jax", "tvc"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in common.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = set(_imports(path)) & set(common.FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").rglob("*.py"):
        assert "tvc_torch" not in set(_imports(path)), path


def test_loading_every_module_and_the_program_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, perfbench, perfbench.drivers, perfbench.reference\n"
        "for pkg in (perfbench, perfbench.drivers, perfbench.reference):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        if m.name != 'tests': importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "import tvc_torch.pipeline, tvc_torch.serving, tvc_torch.models.qwen\n"
        "from perfbench import common\n"
        "print(common.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=common.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
