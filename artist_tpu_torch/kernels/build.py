"""Build the hand-written CUDA sources of ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and builds with ``nvcc``
into its own library, ``artist_tpu_torch/_build/lib<name>_<hash>.so``, at
first use. The hash covers the source, the headers of ``csrc/`` (``*.cuh``)
and the flags, so an edited source or header is rebuilt. The wrappers load a
library with ``ctypes`` (:func:`load_library`); :func:`build_all` builds every
source at once, one ``nvcc`` process each, all started together.

Flags: ``sm_90a`` (Hopper), ``-O3``, IEEE division and square root, no
``--use_fast_math``; ``-Xptxas -v`` reports registers and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(source: pathlib.Path) -> pathlib.Path:
    headers = b"".join(header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless already built.

    Returns the library path and the compiler's output (the ``-Xptxas -v``
    register and spill report), empty when nothing was built.
    """
    source = CSRC_DIR / f"{name}.cu"
    target = _library_path(source)
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    result = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    if result.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{result.stdout}")
    os.replace(partial, target)
    return target, result.stdout


def build_all() -> dict[str, tuple[pathlib.Path, str]]:
    """:func:`build_library` for every ``csrc/*.cu``, all started together:
    ``{name: (library path, compiler output)}``. Leaving the pool waits for
    every ``nvcc``, so none is left running when one fails."""
    names = sorted(source.stem for source in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build_library, names)))


def load_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<name>.cu``'s library, built at first use."""
    if name not in _libraries:
        path, _ = build_library(name)
        _libraries[name] = ctypes.CDLL(str(path))
    return _libraries[name]
