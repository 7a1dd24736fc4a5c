"""The viable heliostats of the kinematics reconstruction: a walk over a PAINT download.

Counterpart of ``examples/paint_plots/reconstruction_generate_viable_heliostats_list.py``.
A heliostat is viable where at least ``minimum_number_of_measurements`` of its
calibration files carry both the UTIS and the HeliOS centroid under ``focal_spot``
and have their flux image beside them. The layout is PAINT's::

    <data_dir>/<name>/Properties/<name>-heliostat-properties.json
    <data_dir>/<name>/Calibration/<id>-calibration-properties.json
    <data_dir>/<name>/Calibration/<id>-<calibration_image_type>.png

The sorted list (name, calibration files, flux images, properties file) is written
to ``<results_dir>/viable_heliostats.json``; host code only::

    python -m artist_tpu_torch.examples.paint_plots.reconstruction_generate_viable_heliostats_list \\
        [--config C] [--data_dir D] [--results_dir R] [--minimum_number_of_measurements N]
"""

from __future__ import annotations

import json
import pathlib
import re

from artist_tpu_torch.examples.paint_plots._config import load_config

HELIOSTAT_NAME_PATTERN = re.compile(r"^[A-Z]{2}[0-9]{2}$")
CALIBRATION_SUFFIX = "-calibration-properties.json"
FOCAL_SPOT_KEY = "focal_spot"
UTIS_KEY = "UTIS"
HELIOS_KEY = "HeliOS"
VIABLE_FILE = "viable_heliostats.json"


def find_viable_heliostats(
    data_directory: pathlib.Path,
    minimum_number_of_measurements: int,
    maximum_number_of_heliostats: int,
    excluded_heliostats: set[str],
    calibration_image_type: str,
) -> list[dict]:
    """The heliostats of ``data_directory`` (in name order, at most
    ``maximum_number_of_heliostats``) with ``minimum_number_of_measurements``
    dual-centroid calibration files and their flux images; each keeps its first
    ``minimum_number_of_measurements`` files."""
    found = []
    heliostat_dirs = sorted(
        d for d in pathlib.Path(data_directory).iterdir() if d.is_dir() and HELIOSTAT_NAME_PATTERN.match(d.name)
    )
    for heliostat_dir in heliostat_dirs:
        name = heliostat_dir.name
        if name in excluded_heliostats:
            print(f"Skipping excluded heliostat: {name}")
            continue
        properties_path = heliostat_dir / "Properties" / f"{name}-heliostat-properties.json"
        calibration_dir = heliostat_dir / "Calibration"
        if not calibration_dir.exists():
            continue
        calibrations, flux_images = [], []
        for calibration_path in sorted(calibration_dir.glob(f"*{CALIBRATION_SUFFIX}")):
            try:
                with calibration_path.open() as handle:
                    focal_spots = json.load(handle).get(FOCAL_SPOT_KEY, {})
            except (OSError, ValueError, AttributeError) as error:  # a file that is not PAINT's JSON
                print(f"Warning: skipping {calibration_path}: {error}")
                continue
            if UTIS_KEY in focal_spots and HELIOS_KEY in focal_spots:
                stem = calibration_path.name.removesuffix(CALIBRATION_SUFFIX)
                image_path = calibration_dir / f"{stem}-{calibration_image_type}.png"
                if image_path.exists():
                    calibrations.append(calibration_path)
                    flux_images.append(image_path)
        if len(calibrations) >= minimum_number_of_measurements:
            found.append(
                {
                    "name": name,
                    "calibrations": [str(p) for p in calibrations[:minimum_number_of_measurements]],
                    "flux_images": [str(p) for p in flux_images[:minimum_number_of_measurements]],
                    "properties": str(properties_path),
                }
            )
            print(f"Added heliostat {name} ({len(found)} so far).")
        if len(found) >= maximum_number_of_heliostats:
            break
    return sorted(found, key=lambda item: item["name"])


def read_viable_heliostats(results_dir: pathlib.Path) -> list[dict]:
    """The list this script wrote under ``results_dir``."""
    path = pathlib.Path(results_dir) / VIABLE_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"The viable heliostat list at {path} was not found; run "
            "reconstruction_generate_viable_heliostats_list first."
        )
    with open(path) as handle:
        return json.load(handle)


def main(argv: list[str] | None = None) -> pathlib.Path:
    args = load_config(
        [
            "data_dir",
            "results_dir",
            "minimum_number_of_measurements",
            "maximum_number_of_heliostats_for_reconstruction",
            "excluded_heliostats_for_reconstruction",
            "calibration_image_type",
        ],
        description=__doc__.splitlines()[0],
        argv=argv,
    )
    viable = find_viable_heliostats(
        data_directory=args.data_dir,
        minimum_number_of_measurements=int(args.minimum_number_of_measurements),
        maximum_number_of_heliostats=int(args.maximum_number_of_heliostats_for_reconstruction),
        excluded_heliostats=set(args.excluded_heliostats_for_reconstruction or []),
        calibration_image_type=args.calibration_image_type,
    )
    args.results_dir.mkdir(parents=True, exist_ok=True)
    output = args.results_dir / VIABLE_FILE
    with open(output, "w") as handle:
        json.dump(viable, handle, indent=1)
    print(f"{len(viable)} viable heliostats saved to {output}")
    return output


if __name__ == "__main__":
    main()
