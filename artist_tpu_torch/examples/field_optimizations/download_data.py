"""Check a PAINT data directory for the field-optimization example, offline.

Counterpart of ``examples/field_optimizations/download_data.py``, which, with no
network, only validates a pre-downloaded directory. The expected layout is flat::

    <data_dir>/tower-measurements.json
    <data_dir>/<heliostat>-heliostat-properties.json
    <data_dir>/<heliostat>-calibration-properties_<id>.json
    <data_dir>/<heliostat>-flux-centered_<id>.png

Usage::

    python -m artist_tpu_torch.examples.field_optimizations.download_data [config.yaml] [--data-dir DIR]
"""

from __future__ import annotations

import argparse

from artist_tpu_torch.examples.field_optimizations.generate_scenarios import (
    config_arguments,
    data_directory,
    load_config,
)


def validate(config: dict) -> list[str]:
    """The files the configuration needs that ``data_dir`` lacks, one line each."""
    data_dir = data_directory(config)
    problems = []
    if not (data_dir / config["tower_file_name"]).exists():
        problems.append(f"missing tower measurements in {data_dir}")
    for name in config["heliostats"]:
        if not (data_dir / f"{name}-heliostat-properties.json").exists():
            problems.append(f"missing heliostat properties for {name}")
        if not list(data_dir.glob(f"{name}-calibration-properties_*.json")):
            problems.append(f"missing calibration data for {name}")
    return problems


def main(argv: list[str] | None = None) -> int:
    args = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    problems = validate(load_config(args.config, args.data_dir))
    for problem in problems:
        print(f"ERROR: {problem}")
    if not problems:
        print("data directory complete")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
