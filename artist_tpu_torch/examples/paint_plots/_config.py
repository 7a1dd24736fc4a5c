"""The configuration that every script of the PAINT plot example reads.

Counterpart of ``examples/paint_plots/_config.py``. A script calls
:func:`load_config` with the option names it needs: the values of
``paint_plot_config.yaml`` (or the file ``--config`` names) seed the defaults of its
command line, and its flags override them (a dict or a list given as JSON). A
relative path resolves against the
working directory, or against ``root`` where the caller gives one. PyYAML is
imported only where a file is read (:func:`read_config`).
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import warnings

CONFIG = pathlib.Path(__file__).with_name("paint_plot_config.yaml")

DEFAULTS = {
    "metadata_root": "./",
    "metadata_file_name": "calibration_metadata_all_heliostats.csv",
    "data_dir": "./paint_data",
    "tower_file_name": "WRI1030197-tower-measurements.json",
    "scenarios_dir": "./paint_plots/scenarios",
    "results_dir": "./paint_plots/results",
    "plots_dir": "./paint_plots/plots",
    "minimum_number_of_measurements": 10,
    "maximum_number_of_heliostats_for_reconstruction": 2200,
    "excluded_heliostats_for_reconstruction": [],
    "calibration_image_type": "flux",
    "heliostats_for_raytracing": {},
    "number_of_points_to_plot": 100,
    "random_seed": 7,
}
PATH_OPTIONS = {"metadata_root", "data_dir", "scenarios_dir", "results_dir", "plots_dir"}


def make_absolute(path: str | pathlib.Path, root: str | pathlib.Path | None = None) -> pathlib.Path:
    """``path`` as an absolute path: a relative one under ``root`` (default: the
    working directory)."""
    path = pathlib.Path(path).expanduser()
    return path if path.is_absolute() else (pathlib.Path(root or pathlib.Path.cwd()) / path).resolve()


def read_config(path: str | pathlib.Path | None = None) -> dict:
    """The YAML file ``path`` (default: :data:`CONFIG`) as a dict; an empty dict, with a
    warning, where the file does not exist."""
    path = pathlib.Path(CONFIG if path is None else path)
    if not path.exists():
        warnings.warn(f"Configuration file not found at {path}; using defaults.")
        return {}
    import yaml

    with open(path) as handle:
        return yaml.safe_load(handle) or {}


def load_config(
    option_names: list[str],
    description: str,
    argv: list[str] | None = None,
    root: str | pathlib.Path | None = None,
    parser: argparse.ArgumentParser | None = None,
) -> argparse.Namespace:
    """Parse ``--config`` and the options ``option_names`` from ``argv`` (default: the
    command line), their defaults from the configuration file, then
    :data:`DEFAULTS`; the path options made absolute (:func:`make_absolute` with
    ``root``). ``parser`` may carry a script's own arguments."""
    parser = parser or argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=str(CONFIG), help="Path to the YAML configuration file.")
    args, remaining = parser.parse_known_args(argv)
    config = read_config(args.config)
    for name in option_names:
        default = copy.deepcopy(config.get(name, DEFAULTS.get(name)))
        if name in PATH_OPTIONS and default is not None:
            default = str(make_absolute(default, root))
        option_type = type(DEFAULTS.get(name, ""))
        # A dict or list on the command line is JSON: '{"AA39": 149576}', '["BE20"]'.
        parser.add_argument(f"--{name}", type=json.loads if option_type in (dict, list) else option_type,
                            default=default)
    namespace = parser.parse_args(remaining, namespace=args)
    for name in option_names:
        if name in PATH_OPTIONS:
            setattr(namespace, name, make_absolute(getattr(namespace, name), root))
    return namespace
