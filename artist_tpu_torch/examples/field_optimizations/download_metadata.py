"""The calibration-metadata table of the field-optimization example, scanned offline.

Counterpart of ``examples/field_optimizations/download_metadata.py``: with no
network, the table that ``generate_viable_heliostats_list.py`` filters is built by
scanning a pre-downloaded ``data_dir``; every
``<name>-calibration-properties_<id>.json`` gives one row with its flux images::

    python -m artist_tpu_torch.examples.field_optimizations.download_metadata [config.yaml] [--data-dir DIR]
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib

from artist_tpu_torch.examples.field_optimizations.generate_scenarios import (
    config_arguments,
    data_directory,
    load_config,
)

COLUMNS = (
    "HeliostatId", "CalibrationId", "DateTime", "TargetName", "CalibrationProperties", "Flux", "FluxCentered",
    "HeliostatProperties",
)


def metadata_directory(config: dict) -> pathlib.Path:
    return pathlib.Path(config.get("metadata_root", config.get("results_dir", "."))) / "metadata"


def build_metadata(config: dict) -> pathlib.Path:
    """Scan ``data_dir`` and write ``<metadata_root>/metadata/calibration_metadata.csv``;
    return its path."""
    data_dir = data_directory(config)
    directory = metadata_directory(config)
    directory.mkdir(parents=True, exist_ok=True)
    out_path = directory / "calibration_metadata.csv"
    rows = []
    for properties_path in sorted(data_dir.glob("*-calibration-properties_*.json")):
        name, _, calibration_id = properties_path.stem.rpartition("_")
        heliostat = name.removesuffix("-calibration-properties")
        with open(properties_path, encoding="utf-8") as handle:
            properties = json.load(handle)
        flux = data_dir / f"{heliostat}-flux_{calibration_id}.png"
        flux_centered = data_dir / f"{heliostat}-flux-centered_{calibration_id}.png"
        rows.append(
            {
                "HeliostatId": heliostat,
                "CalibrationId": calibration_id,
                # PAINT's metadata carries acquisition times; local files may not.
                "DateTime": properties.get("datetime", ""),
                "TargetName": properties.get("target_name", ""),
                "CalibrationProperties": str(properties_path),
                "Flux": str(flux) if flux.exists() else "",
                "FluxCentered": str(flux_centered) if flux_centered.exists() else "",
                "HeliostatProperties": str(data_dir / f"{heliostat}-heliostat-properties.json"),
            }
        )
    with open(out_path, "w", newline="", encoding="utf-8") as handle:
        writer = csv.DictWriter(handle, fieldnames=list(COLUMNS))
        writer.writeheader()
        writer.writerows(rows)
    print(f"Wrote metadata for {len(rows)} calibration measurements to {out_path}")
    return out_path


def main(argv: list[str] | None = None) -> pathlib.Path:
    args = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    return build_metadata(load_config(args.config, args.data_dir))


if __name__ == "__main__":
    main()
