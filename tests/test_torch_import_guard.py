"""The port, ``chip_smoke.py`` and the ``bench_*.py`` scripts import
neither JAX nor the JAX package.

An AST scan of every ``import`` and ``from ... import`` in
``src/repro_torch/**/*.py``, ``chip_smoke.py``, ``bench_flash_bwd.py``,
``bench_flash_fwd.py``, ``bench_depthwise_rmsnorm.py``, ``bench_decode.py``,
``bench_decode_paged.py``, ``bench_decode_spec.py``, ``compare_ptxas.py`` and
``cotenancy_noise.py``:
a module named ``jax`` (or under it) or ``repro`` (or under it) fails the
test. Only the tests import both packages.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_flash_bwd.py", ROOT / "bench_flash_fwd.py",
    ROOT / "bench_depthwise_rmsnorm.py", ROOT / "bench_decode.py",
    ROOT / "bench_decode_paged.py", ROOT / "bench_decode_spec.py",
    ROOT / "compare_ptxas.py", ROOT / "cotenancy_noise.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_guard_flags_what_it_must():
    src = "import jax.numpy\nfrom repro.models import x\nimport repro_torch\n"
    hits = [n for _, n in _imported_modules(ast.parse(src)) if _banned(n)]
    assert hits == ["jax.numpy", "repro.models"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists(), f"{path} is missing"
    bad = [f"{path.relative_to(ROOT)}:{line}: {name}"
           for line, name in _imported_modules(ast.parse(path.read_text()))
           if _banned(name)]
    assert not bad, "the port must not import JAX or the JAX package:\n" + "\n".join(bad)
