"""Export the field's heliostat surfaces as STRAL ``.binp`` files.

Counterpart of ``examples/field_optimizations/generate_stral_inputs.py``: each
heliostat's NURBS surface (the reconstructed control points of
``surface_reconstruction.npz`` where ``generate_results`` wrote them) evaluated
on the device at 50 x 50 points a facet, without canting or translation, and
written in STRAL's binary deflectometry layout (surface header ``=5f2I2f``, facet
headers ``=i9fI``, 7-float point records, the tracking block). The files read
back through ``artist_tpu_torch.io.stral.extract_stral_deflectometry_data``::

    python -m artist_tpu_torch.examples.field_optimizations.generate_stral_inputs [config.yaml] \\
        [--data-dir DIR] [--device cuda]

The command reads the scenario file with ``h5py``; :func:`stral_inputs` takes a
scenario in memory.
"""

from __future__ import annotations

import argparse
import pathlib
import struct

import numpy as np
import torch

from artist_tpu_torch.examples.field_optimizations.generate_scenarios import (
    SCENARIO_FILE,
    config_arguments,
    load_config,
)
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5

SURFACE_HEADER = struct.Struct("=5f2I2f")
FACET_HEADER = struct.Struct("=i9fI")
SURFACE_POINTS = (50, 50)
TRACKING_DLL = "STJ_HELIOKON.DLL"
TRACKING_METHOD = "TrackingBasic"


def save_binp(
    output_path: pathlib.Path,
    heliostat_position: np.ndarray,
    width: float,
    height: float,
    number_of_facets_grid: tuple[int, int],
    facet_translations: np.ndarray,
    canting: np.ndarray,
    points_per_facet: list[np.ndarray],
    normals_per_facet: list[np.ndarray],
    axis_offset: float = 0.0,
    mirror_offset: float = 0.0,
) -> None:
    """Write one STRAL ``.binp`` file. STRAL's frame swaps the horizontal axes: the
    header stores (north, -east, up). Each point record is its point, its normal and
    its share of the heliostat's area."""
    output_path.parent.mkdir(parents=True, exist_ok=True)
    number_of_facets = len(points_per_facet)
    with open(output_path, "wb") as handle:
        handle.write(
            SURFACE_HEADER.pack(
                float(heliostat_position[1]),
                float(-heliostat_position[0]),
                float(heliostat_position[2]),
                float(width),
                float(height),
                int(number_of_facets_grid[0]),
                int(number_of_facets_grid[1]),
                float(axis_offset),
                float(mirror_offset),
            )
        )
        for facet in range(number_of_facets):
            points = np.asarray(points_per_facet[facet], np.float32)
            normals = np.asarray(normals_per_facet[facet], np.float32)
            handle.write(
                FACET_HEADER.pack(
                    0,
                    *np.asarray(facet_translations[facet, :3], np.float32),
                    *np.asarray(canting[facet, 0, :3], np.float32),
                    *np.asarray(canting[facet, 1, :3], np.float32),
                    points.shape[0],
                )
            )
            power = width * height / (points.shape[0] * number_of_facets)
            records = np.concatenate([points, normals, np.full((points.shape[0], 1), power, np.float32)], axis=1)
            handle.write(records.astype(np.float32).tobytes())
        handle.write(np.zeros(2, np.float32).tobytes())
        for text in (TRACKING_DLL, TRACKING_METHOD):
            handle.write(len(text).to_bytes(4, byteorder="little"))
            handle.write(text.encode("ascii"))
    print(f"Wrote .binp file to {output_path}")


def stral_inputs(
    scenario: Scenario,
    output_dir: pathlib.Path | str,
    control_points: dict[str, np.ndarray] | None = None,
    device: torch.device | str = "cuda",
) -> list[pathlib.Path]:
    """One ``<name>.binp`` a heliostat of ``scenario`` in ``output_dir``: the surface of
    its group's control points, or ``control_points["group_<i>_control_points"]`` where
    given, evaluated on ``device`` at :data:`SURFACE_POINTS` a facet."""
    device = torch.device(device)
    scenario.to(device)
    output_dir = pathlib.Path(output_dir)
    evaluation_points = create_nurbs_evaluation_grid(SURFACE_POINTS, device=device)
    written = []
    for group_index, group in enumerate(scenario.heliostat_groups):
        points = group.nurbs_control_points
        key = f"group_{group_index}_control_points"
        if control_points is not None and key in control_points:
            points = torch.as_tensor(control_points[key], dtype=torch.float32, device=device)
        # STRAL stores each facet's local cloud, with its canting and translation apart.
        with torch.no_grad():
            surface_points, surface_normals = evaluate_nurbs_surfaces(points, group.nurbs_degrees, evaluation_points)
        surface_points, surface_normals = surface_points.cpu().numpy(), surface_normals.cpu().numpy()
        canting = group.canting.cpu().numpy()
        translations = group.facet_translations.cpu().numpy()
        positions = group.positions.cpu().numpy()
        for index, name in enumerate(group.names):
            facets = canting.shape[1]
            path = output_dir / f"{name}.binp"
            save_binp(
                output_path=path,
                heliostat_position=positions[index],
                width=2.0 * float(np.linalg.norm(canting[index, :, 0, :3], axis=1).max()),
                height=2.0 * float(np.linalg.norm(canting[index, :, 1, :3], axis=1).max()),
                number_of_facets_grid=(facets, 1),
                facet_translations=translations[index],
                canting=canting[index],
                points_per_facet=[surface_points[index, f, :, :3] for f in range(facets)],
                normals_per_facet=[surface_normals[index, f, :, :3] for f in range(facets)],
            )
            written.append(path)
    return written


def generate_stral_inputs(config: dict, device: torch.device | str = "cuda") -> list[pathlib.Path]:
    """:func:`stral_inputs` of the example's scenario file (needs ``h5py``), with the
    reconstructed control points where ``results_dir`` holds them, into
    ``data_for_stral_dir``."""
    results_dir = pathlib.Path(config["results_dir"])
    scenario_path = pathlib.Path(config["scenarios_dir"]) / SCENARIO_FILE
    if not scenario_path.exists():
        raise FileNotFoundError(f"{scenario_path} not found - run generate_scenarios first.")
    scenario = load_scenario_from_hdf5(scenario_path, number_of_surface_points_per_facet=SURFACE_POINTS, device=device)
    reconstruction = results_dir / "surface_reconstruction.npz"
    control_points = dict(np.load(reconstruction)) if reconstruction.exists() else None
    output_dir = pathlib.Path(config.get("data_for_stral_dir", results_dir / "data_for_stral"))
    return stral_inputs(scenario, output_dir, control_points, device)


def main(argv: list[str] | None = None) -> list[pathlib.Path]:
    parser = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    return generate_stral_inputs(load_config(args.config, args.data_dir), args.device)


if __name__ == "__main__":
    main()
