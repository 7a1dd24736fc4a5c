"""Rows 2 and 4's kernel, the splat backward gather, against a parent checkout's, in turns.

    python3 -m artist_tpu_torch.tools.backward_turns --parent CHECKOUT [--rounds 1]
        [--paint-epochs 200] [--shapes surface,window,...]

Compiles ``csrc/splat.cu`` of this checkout and of ``--parent`` (any checkout whose
``splat.cu`` has the same ``splat_backward`` C interface) with the build's flags into
libraries of their own under ``artist_tpu_torch/_build/``, both at once. Then, at the
six shapes that the main path gives rows 2 and 4 (``SHAPES``: the surface step's
chunk, the block-window step's chunk in place, the surface reconstructor's train
chunk, the plant chunk, the flux-driven kinematics train batch and the PAINT
reconstruction's train batch, each built as ``chip_smoke.py`` builds it, on a
cotangent drawn from a seed), it

- launches each library through the port's wrapper (``kernels.splat.backward_gather``,
  the library in the port's place), holds its gradients against
  ``splat_backward_plain`` within ``chip_smoke.BACKWARD_TOLERANCE`` and two launches of
  each bit for bit;
- times each library by CUDA events over 20 back-to-back launches and replayed from a
  CUDA graph (``chip_smoke.event_ms``, ``chip_smoke.graph_ms``), ``--rounds`` times in
  turns: parent, this, this, parent;
- gives the bound (``chip_smoke.splat_work``: each input byte once), the sector floor
  (the same streams and every 32-byte sector of the cotangent a tap falls on) and the
  count of 64-byte segments the taps fall on.

Then, unless ``--paint-epochs 0``, it runs phase 18a's reconstruction
(``generate_reconstruction_results``, both centroid runs, cut to ``--paint-epochs``) on
the same PAINT field once with each of parent, this, this, parent in the port's splat
library (the forward's code is the same in both), and gives each run's seconds an epoch.

Prints the card's name and power limit, a line per shape, and one JSON line. Needs one
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import logging
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as c  # noqa: E402
from artist_tpu_torch.kernels import build  # noqa: E402
from artist_tpu_torch.tools.sass_counts import ptxas_report  # noqa: E402

splat_module = importlib.import_module("artist_tpu_torch.kernels.splat")

SAMPLE_LIMIT = c.reconstruction_generate_results.SAMPLE_LIMIT
SHAPES = ("surface", "window", "reconstruction", "plant", "kinematics", "paint")
# Beside the 32-byte sectors, the 64-byte segments (two sectors, the pair the L2 may
# fetch together) of the cotangent that the taps fall on are counted.
SEGMENT_BYTES = 64


def compile_library(source: pathlib.Path, tag: str) -> tuple[pathlib.Path, str]:
    """``source`` compiled with the build's flags: the library and nvcc's output."""
    headers = b"".join(header.read_bytes() for header in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(build.NVCC_FLAGS).encode())
    target = build.BUILD_DIR / f"turns_{tag}_{digest.hexdigest()[:16]}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}")
    return target, done.stdout


def gather(library: ctypes.CDLL, e, u, w, g, height: int, width: int):
    """One launch of ``library``'s backward through the port's own wrapper
    (``kernels.splat.backward_gather``), with ``library`` in the port's place."""
    splat_module._library = library
    return splat_module.backward_gather(e, u, w, g, height, width)


def shape_rays(name: str, device: torch.device, paint: tuple | None = None):
    """The rays of one of ``SHAPES`` as the main path gives them to rows 2 and 4."""
    if name == "surface":
        return c.first_chunk_rays(c.flagship_inputs(device))
    if name == "window":
        inputs = c.flagship_inputs(device, **c.BLOCK_WINDOW)
        e, u, w = c.first_chunk_rays(inputs)
        return tuple(x.reshape(e.shape[0], inputs.config.ray_chunk, -1) for x in (e, u, w))
    if name == "reconstruction":
        return c.reconstruction_chunk_rays(device)
    if name == "plant":
        return c.plant_chunk_inputs(device, None)["splat"]
    if name == "kinematics":
        known = c.known_rotation_deviations(c.KINEMATICS["heliostats"])
        data = c.kinematics_calibration(c.kinematics_scenario(device, c.KINEMATICS), known, c.KINEMATICS["samples"],
                                        c.KINEMATICS["bitmap"])
        reconstructor = c.kinematics_reconstructor(device, c.KINEMATICS_FLUX, data, c.RAYTRACING,
                                                   c.kinematics_configuration(0))
        return c.kinematics_rays(reconstructor, c.reconstructor_batches(reconstructor)[0])
    if name == "paint":
        scenario, utis = paint
        parser = c.CalibrationDataParser(utis, scenario.heliostat_groups[0].names, SAMPLE_LIMIT)
        reconstructor = c.paint_reconstructor(scenario, parser)
        return c.kinematics_rays(reconstructor, c.reconstructor_batches(reconstructor)[0])
    raise ValueError(f"no shape {name!r}")


def time_shape(name: str, rays, libraries: dict[str, ctypes.CDLL], rounds: int, height: int, width: int,
               seed: int) -> dict:
    """Both libraries at one shape: checked against the plain version, then timed in turns."""
    e, u, w = rays
    device = e.device
    g = torch.randn((e.shape[0], height, width), device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    plain = splat_module.splat_backward_plain(*(x.reshape(x.shape[0], -1) for x in rays), g, height, width)
    errors = {}
    for tag, library in libraries.items():
        grads = gather(library, e, u, w, g, height, width)
        c.check_repeatable(f"{tag} at {name}", grads, gather(library, e, u, w, g, height, width))
        flat = tuple(x.reshape(x.shape[0], -1) for x in grads)
        errors[tag] = c.check_backward(f"{tag} at {name}", flat, plain, w, g)[0]
        del grads, flat
    del plain
    work = c.splat_work(*(x.reshape(x.shape[0], -1) for x in rays), height, width)
    bound, sector_floor = work["backward_bound"], work["sector_floor_ms"]
    pixels = torch.unique(work["taps"])
    counts = dict(valid=work["valid"], touched=work["touched"], sectors=work["sectors"],
                  segments=int(torch.unique(torch.div(pixels, SEGMENT_BYTES // 4, rounding_mode="floor")).numel()))
    del work, pixels
    c.empty_cache(device)
    order = list(libraries) + list(libraries)[::-1]
    times: dict[str, dict[str, list[float]]] = {tag: {"events": [], "graph": []} for tag in libraries}
    for _ in range(rounds):
        for tag in order:
            fn = lambda library=libraries[tag]: gather(library, e, u, w, g, height, width)  # noqa: E731
            times[tag]["events"].append(c.event_ms(fn))
            times[tag]["graph"].append(c.graph_ms(fn))
    return dict(shape=list(e.shape), bound_ms=bound[0], bound_by=bound[1], sector_floor_ms=sector_floor, **counts,
                max_abs_err=errors, ms=times)


def paint_turns(device: torch.device, scenario, utis, libraries: dict[str, ctypes.CDLL], epochs: int) -> list[dict]:
    """Phase 18a's two reconstruction runs, cut to ``epochs``, once with each library in the
    port's place: parent, this, this, parent. Seconds an epoch (median) of each run."""
    data = {"UTIS": utis, "HeliOS": c.helios_centroids(utis)}
    names = scenario.heliostat_groups[0].names
    turns = []
    # A short first run with this checkout's library takes the start-up costs out of the turns.
    for index, tag in enumerate(("this", "parent", "this", "this", "parent")):
        splat_module._library = libraries[tag]
        recorders = {centroid: c.LossRecorder() for centroid in data}
        c.synchronize(device)
        start = time.perf_counter()
        c.reconstruction_generate_results.generate_reconstruction_results(
            scenario, max_epoch=epochs if index else 2, device=device, on_epoch=recorders,
            data_parser=lambda centroid: c.CalibrationDataParser(data[centroid], names, SAMPLE_LIMIT),
        )
        c.synchronize(device)
        if not index:
            continue
        turns.append(dict(
            library=tag, seconds=time.perf_counter() - start,
            epoch_seconds_median={centroid: float(np.median(np.diff(r.ends))) for centroid, r in recorders.items()},
            epochs={centroid: len(r.epochs) for centroid, r in recorders.items()},
        ))
    splat_module._library = None
    return turns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--paint-epochs", type=int, default=200)
    parser.add_argument("--shapes", default=",".join(SHAPES))
    args = parser.parse_args()
    # The PAINT field's suns leave some heliostats without a motor position, a warning a scenario.
    logging.getLogger("artist_tpu_torch.field").setLevel(logging.ERROR)
    if not torch.cuda.is_available():
        print("backward_turns: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])

    sources = {"parent": args.parent.resolve() / "artist_tpu_torch/kernels/csrc/splat.cu",
               "this": build.CSRC_DIR / "splat.cu"}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda item: compile_library(item[1], item[0]), sources.items())))
    ptxas = {tag: ptxas_report(output) for tag, (_, output) in built.items()}
    libraries = {tag: splat_module.bind(ctypes.CDLL(str(path))) for tag, (path, _) in built.items()}
    width, height = c.BITMAP

    shapes = [name for name in args.shapes.split(",") if name]
    paint = None
    if "paint" in shapes or args.paint_epochs:
        scenario, _, utis, *_ = c.paint_field(device)
        paint = (scenario, utis)
    results = {}
    for index, name in enumerate(shapes):
        start = time.perf_counter()
        rays = shape_rays(name, device, paint)
        made = time.perf_counter() - start
        results[name] = time_shape(name, rays, libraries, args.rounds, height, width, c.SEED + 50 + index)
        del rays
        c.empty_cache(device)
        r = results[name]
        print(f"{name} {r['shape']}: {r['valid']} valid rays, {r['touched']} pixels, {r['sectors']} sectors, "
              f"{r['segments']} 64-byte segments; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), sector floor {r['sector_floor_ms']:.4f} ms; rays made in "
              f"{made:.1f} s; "
              + "; ".join(f"{tag} events {t['events']} graph {t['graph']}" for tag, t in r["ms"].items()),
              flush=True)
    splat_module._library = None
    paint_epochs = paint_turns(device, *paint, libraries, args.paint_epochs) if args.paint_epochs else []
    for turn in paint_epochs:
        print(f"18a with {turn['library']}: {turn['seconds']:.2f} s, s an epoch {turn['epoch_seconds_median']}",
              flush=True)
    print(json.dumps(dict(device=torch.cuda.get_device_name(device), parent=str(args.parent), ptxas=ptxas,
                          shapes=results, paint_epochs=paint_epochs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
