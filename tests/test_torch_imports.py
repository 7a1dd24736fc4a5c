"""The port and its scripts import no JAX, flax, optax, h5py or JAX-package module.

The machine with the card has none of them. Each source is parsed (AST, not
text search) and every ``import`` / ``from ... import`` is checked; a second
test imports every module of the port in a fresh interpreter in which those
packages cannot be imported at all.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "h5py", "artist_tpu"}
SOURCES = sorted((REPO / "artist_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "profile_torch_step.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import; the port imports by absolute name")
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_every_port_module_imports_without_jax():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES
        if p.parent != REPO
    ]
    program = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for module in {modules!r}:\n"
        "    importlib.import_module(module)\n"
        "import chip_smoke\n"
        "print('imported', len(sys.modules))\n"
    )
    done = subprocess.run(
        [sys.executable, "-c", program], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert done.returncode == 0, done.stderr
    assert "imported" in done.stdout
