"""Select the viable heliostats of the field-optimization example.

Counterpart of ``examples/field_optimizations/generate_viable_heliostats_list.py``:
the calibration metadata (``download_metadata.py``) filtered to heliostats with
enough valid measurements, written as two lists, the "baseline" (the
configuration's heliostats) and the "full field" (every heliostat that clears the
threshold). Each entry is ``[name, calibration-properties paths, flux paths for
kinematics, flux paths for surfaces, heliostat-properties path]``::

    python -m artist_tpu_torch.examples.field_optimizations.generate_viable_heliostats_list [config.yaml] \\
        [--data-dir DIR]
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
from collections import defaultdict

from artist_tpu_torch.examples.field_optimizations.download_metadata import metadata_directory
from artist_tpu_torch.examples.field_optimizations.generate_scenarios import config_arguments, load_config

IMAGE_COLUMN = {"flux": "Flux", "flux-centered": "FluxCentered"}


def select(
    rows: list[dict],
    heliostat_names: list[str] | None,
    minimum_number_of_measurements: int,
    maximum_number_of_measurements: int,
    kinematics_image_type: str,
    surface_image_type: str,
    excluded: set[str],
) -> list[list]:
    """Each heliostat's calibration samples: only ``heliostat_names`` where given (the
    baseline), else every heliostat with enough measurements (the full field). Rows
    that lack either image type are dropped; a heliostat's rows are taken in
    (time, calibration id) order, at most ``maximum_number_of_measurements``."""
    by_heliostat: dict[str, list[dict]] = defaultdict(list)
    for row in rows:
        if row["HeliostatId"] in excluded:
            continue
        if heliostat_names is not None and row["HeliostatId"] not in heliostat_names:
            continue
        if not row[IMAGE_COLUMN[kinematics_image_type]] or not row[IMAGE_COLUMN[surface_image_type]]:
            continue
        by_heliostat[row["HeliostatId"]].append(row)

    viable = []
    for heliostat, entries in sorted(by_heliostat.items()):
        if len(entries) < minimum_number_of_measurements:
            continue
        entries = sorted(entries, key=lambda r: (r["DateTime"], r["CalibrationId"]))[:maximum_number_of_measurements]
        viable.append(
            [
                heliostat,
                [r["CalibrationProperties"] for r in entries],
                [r[IMAGE_COLUMN[kinematics_image_type]] for r in entries],
                [r[IMAGE_COLUMN[surface_image_type]] for r in entries],
                entries[0]["HeliostatProperties"],
            ]
        )
    return viable


def generate_lists(config: dict) -> tuple[pathlib.Path, pathlib.Path]:
    """Write ``viable_heliostats_baseline.json`` and ``viable_heliostats_full_field.json``
    under ``results_dir``; return their paths."""
    metadata_file = metadata_directory(config) / "calibration_metadata.csv"
    if not metadata_file.exists():
        raise FileNotFoundError(f"{metadata_file} not found - run download_metadata first.")
    with open(metadata_file, newline="", encoding="utf-8") as handle:
        rows = list(csv.DictReader(handle))

    results_dir = pathlib.Path(config["results_dir"])
    results_dir.mkdir(parents=True, exist_ok=True)
    arguments = (
        int(config.get("minimum_number_of_measurements", 1)),
        int(config.get("maximum_number_of_measurements", 20)),
        config.get("kinematics_reconstruction_image_type", "flux-centered"),
        config.get("surface_reconstruction_image_type", "flux-centered"),
        set(config.get("excluded_heliostats_for_reconstruction", []) or []),
    )
    baseline = select(rows, list(config.get("heliostats", [])) or None, *arguments)
    full_field = select(rows, None, *arguments)

    baseline_path = results_dir / "viable_heliostats_baseline.json"
    full_field_path = results_dir / "viable_heliostats_full_field.json"
    for path, data in ((baseline_path, baseline), (full_field_path, full_field)):
        with open(path, "w", encoding="utf-8") as handle:
            json.dump(data, handle, indent=2)
        print(f"Wrote {len(data)} viable heliostats to {path}")
    return baseline_path, full_field_path


def main(argv: list[str] | None = None) -> tuple[pathlib.Path, pathlib.Path]:
    args = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    return generate_lists(load_config(args.config, args.data_dir))


if __name__ == "__main__":
    main()
