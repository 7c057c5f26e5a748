"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, and
the reference imports nothing of the program.  Module names are compared
by their whole top-level name: ``repro_torch`` begins with ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "erbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            found.add(str(node.args[0].value).split(".")[0])
    return found


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    assert not _imports(path) - {"__future__", "numpy", "itertools",
                                 "erbench"}


def test_whole_top_level_names_are_compared():
    from erbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake.x"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.x"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from erbench import harness, window\n"
            "from erbench.drivers import resolve, serve\n"
            "from erbench.reference import check\n"
            "import erbench.control, repro_torch.api, repro_torch.serve\n"
            "print(harness.forbidden_modules())\n"
            % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
