"""The PAINT download of the PAINT plot example, checked offline.

Counterpart of ``examples/paint_plots/download_data.py``, which fetches the tower
measurements and, for every heliostat of the metadata table, its calibration,
deflectometry and properties files over the network. This command fetches
nothing: it checks a directory downloaded beforehand, in PAINT's layout::

    <data_dir>/<tower_file_name>
    <data_dir>/<name>/Properties/<name>-heliostat-properties.json
    <data_dir>/<name>/Calibration/<id>-calibration-properties.json
    <data_dir>/<name>/Deflectometry/<name>-filled-<date>.h5   (the heliostats_for_raytracing)

and says what is missing::

    python -m artist_tpu_torch.examples.paint_plots.download_data [--config C] [--data_dir D] [--metadata_root M]
"""

from __future__ import annotations

import pathlib

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.download_metadata import metadata_file, metadata_heliostats


def validate(data_dir: pathlib.Path, tower_file_name: str, heliostats: list[str],
             heliostats_for_raytracing: dict | None = None) -> list[str]:
    """What ``data_dir`` lacks, one line each: the tower file, each heliostat's
    properties and calibration files, and the deflectometry of the heliostats for
    ray tracing."""
    data_dir = pathlib.Path(data_dir)
    problems = []
    if not (data_dir / tower_file_name).exists():
        problems.append(f"missing the tower measurements {data_dir / tower_file_name}")
    for name in heliostats:
        if not (data_dir / name / "Properties" / f"{name}-heliostat-properties.json").exists():
            problems.append(f"missing heliostat properties for {name}")
        if not list((data_dir / name / "Calibration").glob("*-calibration-properties.json")):
            problems.append(f"missing calibration data for {name}")
    for name, measurement in (heliostats_for_raytracing or {}).items():
        calibration = data_dir / name / "Calibration" / f"{measurement}-calibration-properties.json"
        if not calibration.exists():
            problems.append(f"missing the calibration {measurement} of {name}")
        if not list((data_dir / name / "Deflectometry").glob(f"{name}-filled-*.h5")):
            problems.append(f"missing deflectometry for {name}")
    return problems


def main(argv: list[str] | None = None) -> int:
    args = load_config(
        ["data_dir", "metadata_root", "metadata_file_name", "tower_file_name", "heliostats_for_raytracing"],
        description=__doc__.splitlines()[0], argv=argv,
    )
    table = metadata_file(args.metadata_root, args.metadata_file_name)
    heliostats = metadata_heliostats(table) if table.exists() else []
    problems = [] if table.exists() else [f"missing the metadata table {table}: run download_metadata first"]
    problems += validate(args.data_dir, args.tower_file_name, heliostats, args.heliostats_for_raytracing)
    for problem in problems:
        print(f"ERROR: {problem}")
    if not problems:
        print(f"data directory complete: {args.data_dir}")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
