"""The port and its scripts import no JAX, flax, optax or JAX-package module.

The machine with the card has none of them, nor ``h5py``, ``PIL``, ``yaml`` or
``matplotlib``. The first two may appear only as imports inside the functions of
the four ingress modules that read or write HDF5 or PNG files; the last two only
inside the functions of the entry points (tutorials, examples, tools) that read a
configuration file or draw a plot. Each source is parsed (AST, not text
search) and every ``import`` / ``from ... import`` is checked; a second test
imports every module of the port in a fresh interpreter in which all of these
packages cannot be imported at all, and the file readers and writers, called
there, raise ``ImportError``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "artist_tpu"}
# Packages for files, allowed only inside the functions of the ingress modules.
FILE_PACKAGES = {"h5py", "PIL"}
INGRESS_MODULES = {
    "artist_tpu_torch/scenario/scenario.py",
    "artist_tpu_torch/scenario/h5_generator.py",
    "artist_tpu_torch/io/paint_scenario_parser.py",
    "artist_tpu_torch/io/calibration.py",
}
# Packages for a configuration file or a plot, allowed only inside functions.
ENTRY_POINT_PACKAGES = {"yaml", "matplotlib"}
# The entry points: checked like every source, named here so that a missing one fails.
ENTRY_POINTS = (
    "artist_tpu_torch/tutorials/generate_scenario_from_paint.py",
    "artist_tpu_torch/tutorials/generate_scenario_from_stral.py",
    "artist_tpu_torch/tutorials/single_heliostat_raytracing.py",
    "artist_tpu_torch/tutorials/field_raytracing_sharded.py",
    "artist_tpu_torch/tutorials/surface_reconstruction.py",
    "artist_tpu_torch/tutorials/kinematics_reconstruction.py",
    "artist_tpu_torch/tutorials/aim_point_optimization.py",
    "artist_tpu_torch/tutorials/multi_process_reconstruction.py",
    "artist_tpu_torch/examples/field_optimizations/generate_scenarios.py",
    "artist_tpu_torch/examples/field_optimizations/download_data.py",
    "artist_tpu_torch/examples/field_optimizations/download_metadata.py",
    "artist_tpu_torch/examples/field_optimizations/generate_viable_heliostats_list.py",
    "artist_tpu_torch/examples/field_optimizations/generate_results.py",
    "artist_tpu_torch/examples/field_optimizations/generate_stral_inputs.py",
    "artist_tpu_torch/examples/field_optimizations/generate_plots.py",
    "artist_tpu_torch/tools/flagship_step.py",
    "artist_tpu_torch/tools/ablate_step.py",
    "artist_tpu_torch/tools/memory_report.py",
)
SOURCES = sorted((REPO / "artist_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "profile_torch_step.py"]


def _imported_roots(path: Path) -> dict[str, bool]:
    """Each imported top-level package, and whether every import of it lies inside a function."""
    roots: dict[str, bool] = {}

    def visit(node: ast.AST, in_function: bool) -> None:
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import; the port imports by absolute name")
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            roots[root] = roots.get(root, True) and in_function
        in_function = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, in_function)

    visit(ast.parse(path.read_text(), filename=str(path)), False)
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_nothing_forbidden(path):
    roots = _imported_roots(path)
    assert not roots.keys() & FORBIDDEN
    file_imports = {root: local for root, local in roots.items() if root in FILE_PACKAGES}
    if str(path.relative_to(REPO)) in INGRESS_MODULES:
        assert all(file_imports.values()), f"{path}: {file_imports} imported outside a function"
    else:
        assert not file_imports, f"{path}: imports {sorted(file_imports)}"
    entry_imports = {root: local for root, local in roots.items() if root in ENTRY_POINT_PACKAGES}
    assert all(entry_imports.values()), f"{path}: {entry_imports} imported outside a function"


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_are_checked(module):
    path = REPO / module
    assert path in SOURCES
    roots = _imported_roots(path)
    assert not roots.keys() & (FORBIDDEN | FILE_PACKAGES)
    assert all(local for root, local in roots.items() if root in ENTRY_POINT_PACKAGES)


# The multi-process modules and the ray type:
# checked like every source above, named here so that a missing one fails.
PARALLEL_MODULES = (
    "artist_tpu_torch/parallel/env.py",
    "artist_tpu_torch/parallel/mesh.py",
    "artist_tpu_torch/parallel/collectives.py",
    "artist_tpu_torch/scene/rays.py",
)


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_and_rays_are_checked(module):
    path = REPO / module
    assert path in SOURCES
    assert not _imported_roots(path).keys() & (FORBIDDEN | FILE_PACKAGES)


def test_ingress_modules_exist():
    assert all((REPO / module).is_file() for module in INGRESS_MODULES)


def test_every_port_module_imports_without_jax():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES
        if p.parent != REPO
    ]
    program = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN | FILE_PACKAGES | ENTRY_POINT_PACKAGES)!r}:\n"
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


# Each file reader or writer of the ingress modules, called where its package is
# blocked: the call raises ImportError and swaps in no other format.
BLOCKED_CALLS = {
    "load_scenario_from_hdf5": (
        "h5py",
        "from artist_tpu_torch.scenario.scenario import load_scenario_from_hdf5\n"
        "load_scenario_from_hdf5('scenario.h5', device='cpu')\n",
    ),
    "get_number_of_heliostat_groups_from_hdf5": (
        "h5py",
        "from artist_tpu_torch.scenario.scenario import get_number_of_heliostat_groups_from_hdf5\n"
        "get_number_of_heliostat_groups_from_hdf5('scenario.h5')\n",
    ),
    "generate_scenario": (
        "h5py",
        "import pathlib, tempfile\n"
        "from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator\n"
        "H5ScenarioGenerator.generate_scenario(type('G', (), {'file_path': pathlib.Path(tempfile.gettempdir()) / 'x.h5'})())\n",
    ),
    "extract_paint_deflectometry_data": (
        "h5py",
        "from artist_tpu_torch.io.paint_scenario_parser import extract_paint_deflectometry_data\n"
        "extract_paint_deflectometry_data('deflectometry.h5', 4)\n",
    ),
    "load_config": (
        "yaml",
        "from artist_tpu_torch.examples.field_optimizations.generate_scenarios import load_config\n"
        "load_config()\n",
    ),
    "generate_plots": (
        "matplotlib",
        "import pathlib, tempfile\n"
        "from artist_tpu_torch.examples.field_optimizations.generate_plots import plot_loss_histories\n"
        "directory = pathlib.Path(tempfile.mkdtemp())\n"
        "(directory / 'kinematics_loss_history.json').write_text('{}')\n"
        "plot_loss_histories(directory, directory)\n",
    ),
    "load_flux_from_png": (
        "PIL",
        "from artist_tpu_torch.io.calibration import load_flux_from_png\n"
        "load_flux_from_png([('H', ['flux.png'])], ('H',))\n",
    ),
}


@pytest.mark.parametrize("call", sorted(BLOCKED_CALLS))
def test_file_readers_raise_import_error_without_their_package(call):
    package, body = BLOCKED_CALLS[call]
    program = (
        f"import sys\nsys.modules[{package!r}] = None\n"
        "try:\n"
        + "".join(f"    {line}\n" for line in body.splitlines())
        + "except ImportError as error:\n"
        "    print('ImportError:', error)\n"
        "    sys.exit(3)\n"
    )
    done = subprocess.run(
        [sys.executable, "-c", program], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert done.returncode == 3, done.stderr
    assert f"ImportError: import of {package} halted" in done.stdout
