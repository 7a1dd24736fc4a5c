"""The PAINT calibration-metadata table of the PAINT plot example, checked offline.

Counterpart of ``examples/paint_plots/download_metadata.py``, which fetches the
table with the ``paint`` package's STAC client over the network. This command
fetches nothing: it checks that a table downloaded beforehand lies at
``<metadata_root>/metadata/<metadata_file_name>`` and says so, or what is missing::

    python -m artist_tpu_torch.examples.paint_plots.download_metadata [--config C] [--metadata_root M]
"""

from __future__ import annotations

import csv
import pathlib

from artist_tpu_torch.examples.paint_plots._config import load_config

HELIOSTAT_COLUMNS = ("HeliostatId", "heliostat_id")


def metadata_file(metadata_root: pathlib.Path, metadata_file_name: str) -> pathlib.Path:
    return pathlib.Path(metadata_root) / "metadata" / metadata_file_name


def metadata_heliostats(path: pathlib.Path) -> list[str]:
    """The heliostats the metadata table names, sorted."""
    with open(path, newline="") as handle:
        return sorted({name for row in csv.DictReader(handle) for name in [_heliostat(row)] if name})


def _heliostat(row: dict) -> str | None:
    return next((row[column] for column in HELIOSTAT_COLUMNS if row.get(column)), None)


def validate(metadata_root: pathlib.Path, metadata_file_name: str) -> list[str]:
    """What the metadata table lacks, one line each: the file, or any heliostat in it."""
    path = metadata_file(metadata_root, metadata_file_name)
    if not path.exists():
        return [f"missing the metadata table {path}: download it where the network is reachable"]
    if not metadata_heliostats(path):
        return [f"the metadata table {path} names no heliostat"]
    return []


def main(argv: list[str] | None = None) -> int:
    args = load_config(["metadata_root", "metadata_file_name"], description=__doc__.splitlines()[0], argv=argv)
    problems = validate(args.metadata_root, args.metadata_file_name)
    for problem in problems:
        print(f"ERROR: {problem}")
    if not problems:
        print(f"metadata table complete: {metadata_file(args.metadata_root, args.metadata_file_name)}")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
