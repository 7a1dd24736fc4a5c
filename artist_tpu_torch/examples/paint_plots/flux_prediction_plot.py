"""The flux-prediction figure of the PAINT plot, and a demo of one heliostat's prediction.

Counterpart of ``examples/paint_plots/flux_prediction_plot.py``, two commands:

- ``results``: the grid of ``flux_prediction_results.npz`` (one row a heliostat;
  the measured image, the ideal and the fitted prediction, each divided by its
  peak) as ``flux_prediction.pdf`` under a plots directory;
- ``demo``: one heliostat of a directory in the flat layout of the repository's
  test data (``tower-measurements.json``, ``<name>-heliostat-properties.json``,
  ``<name>-calibration-properties_<id>.json``, ``<name>-flux-centered_<id>.png``):
  a scenario of 7 x 7 control points and 120 rays at 50 x 50 points a facet, each
  calibration sample aligned with its measured motor positions, traced on
  ``device``, the prediction cropped around its centre of mass as the PAINT
  images are, and drawn against the measurement.

::

    python -m artist_tpu_torch.examples.paint_plots.flux_prediction_plot results RESULTS.npz --plots_dir DIR
    python -m artist_tpu_torch.examples.paint_plots.flux_prediction_plot demo DATA_DIR --output FILE.png \\
        [--heliostat AA39] [--device cuda]

:func:`flux_grid_data` and :func:`demo_prediction` compute the arrays; the plots are
drawn with ``matplotlib`` on the host. The data directory and the outputs have no
default.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.flux.bitmap import crop_flux_distributions_around_center
from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_heliostats_ideal_surface,
    extract_paint_tower_measurements,
)
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_image
from artist_tpu_torch.util.config import LightSourceConfig, LightSourceListConfig
from artist_tpu_torch.util.logging_utils import set_logger_config

RESOLUTION = (256, 256)
COLUMNS = (("utis", "Measured (UTIS)"), ("ideal", "Ideal surface"), ("fitted", "Fitted surface"))
DEMO_CONTROL_POINTS = (7, 7)
DEMO_RAYS = 120
DEMO_SURFACE_POINTS = (50, 50)
SEED = 7


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def flux_grid_data(results: dict[str, np.ndarray]) -> tuple[list[str], dict[tuple[str, str], np.ndarray | None]]:
    """The heliostats of ``results`` (sorted) and, for each heliostat and column of
    :data:`COLUMNS`, its image divided by its peak (by 1 where the peak is 0), None
    where the results lack it."""
    names = sorted({key.split("/")[0] for key in results})
    grids = {}
    for name in names:
        for key, _ in COLUMNS:
            image = results.get(f"{name}/{key}")
            grids[name, key] = None if image is None else image / (image.max() or 1.0)
    return names, grids


def plot_from_results(results_file: pathlib.Path, plots_dir: pathlib.Path) -> pathlib.Path:
    """``flux_prediction.pdf`` under ``plots_dir``: :func:`flux_grid_data` of the file."""
    names, grids = flux_grid_data(dict(np.load(results_file)))
    plt = _pyplot()
    fig, axes = plt.subplots(len(names), len(COLUMNS), figsize=(4 * len(COLUMNS), 4 * len(names)), squeeze=False)
    for row, name in enumerate(names):
        for column, (key, title) in enumerate(COLUMNS):
            axis = axes[row][column]
            if grids[name, key] is None:
                axis.axis("off")
                continue
            axis.imshow(grids[name, key], cmap="inferno")
            axis.set_title(f"{name}: {title}")
            axis.set_xticks([])
            axis.set_yticks([])
    fig.tight_layout()
    plots_dir = pathlib.Path(plots_dir)
    plots_dir.mkdir(parents=True, exist_ok=True)
    output = plots_dir / "flux_prediction.pdf"
    fig.savefig(output, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return output


def demo_scenario(data_dir: pathlib.Path, heliostat: str, device: torch.device | str = "cuda") -> Scenario:
    """The demo's scenario of ``heliostat`` from the files of ``data_dir``: 7 x 7 control
    points, a sun of 120 rays, loaded at 50 x 50 points a facet from its image."""
    data_dir = pathlib.Path(data_dir)
    power_plant, planar_targets, cylindrical_targets = extract_paint_tower_measurements(
        data_dir / "tower-measurements.json"
    )
    heliostats, prototype = extract_paint_heliostats_ideal_surface(
        paths=[(heliostat, data_dir / f"{heliostat}-heliostat-properties.json")],
        power_plant_position=power_plant.power_plant_position,
        number_of_nurbs_control_points=DEMO_CONTROL_POINTS,
    )
    generator = H5ScenarioGenerator(
        file_path="paint_plots_scenario.h5",
        power_plant_config=power_plant,
        target_area_list_planar_config=planar_targets,
        target_area_list_cylindrical_config=cylindrical_targets,
        light_source_list_config=LightSourceListConfig(
            light_source_list=[LightSourceConfig(light_source_key="sun_1", number_of_rays=DEMO_RAYS)]
        ),
        heliostat_list_config=heliostats,
        prototype_config=prototype,
    )
    return load_scenario_from_image(generator.scenario_image(), DEMO_SURFACE_POINTS, device=device)


def demo_mapping(data_dir: pathlib.Path, heliostat: str) -> list:
    """The heliostat's calibration files of ``data_dir`` whose flux image exists."""
    data_dir = pathlib.Path(data_dir)
    properties = sorted(data_dir.glob(f"{heliostat}-calibration-properties_*.json"))
    fluxes = [data_dir / f"{heliostat}-flux-centered_{p.stem.rsplit('_', 1)[-1]}.png" for p in properties]
    pairs = [(p, f) for p, f in zip(properties, fluxes) if f.exists()]
    return [(heliostat, [p for p, _ in pairs], [f for _, f in pairs])]


@torch.no_grad()
def demo_prediction(
    scenario: Scenario,
    heliostat_data_mapping: list | None = None,
    data_parser=None,
    sun=None,
    device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """Each calibration sample of the scenario's first group aligned with its measured
    motor positions and traced onto 256 x 256, the prediction cropped around its centre
    of mass: ``{"predicted", "measured", "intercept", "flux"}``. ``data_parser``
    (default: the PAINT parser over ``heliostat_data_mapping``) gives the samples,
    ``sun`` (default: the scenario's) the distortions, drawn from a
    ``torch.Generator`` seeded with 7."""
    scenario.to(device)
    group, tower = scenario.heliostat_groups[0], scenario.solar_tower
    sun = sun or scenario.light_sources[0]
    data = (data_parser or PaintCalibrationDataParser()).parse_data_for_reconstruction(
        heliostat_data_mapping=heliostat_data_mapping or [],
        heliostat_names=group.names,
        target_name_to_index=tower.target_name_to_index,
        power_plant_position=scenario.power_plant_position,
        bitmap_resolution=RESOLUTION,
    )
    group_device = group.positions.device
    active = hg.gather_active(
        group,
        torch.as_tensor(hg.active_indices_from_mask(data.active_heliostats_mask), dtype=torch.long, device=group_device),
    )
    points, normals, _ = hg.align_surfaces_with_motor_positions(
        active, torch.as_tensor(data.motor_positions, dtype=torch.float32, device=group_device)
    )
    generator = torch.Generator(device=group_device).manual_seed(SEED)
    distortions_u, distortions_e = sun.get_distortions(generator, points.shape[1], points.shape[0])
    targets = torch.as_tensor(data.target_area_indices, dtype=torch.long, device=group_device)
    flux, intercept, _, _ = trace_rays(
        tower, points, normals,
        torch.as_tensor(data.incident_ray_directions, dtype=torch.float32, device=group_device),
        targets, distortions_u, distortions_e,
        config=RenderConfig(bitmap_resolution=RESOLUTION),
    )
    return dict(
        predicted=crop_flux_distributions_around_center(flux, tower, targets),
        measured=torch.as_tensor(np.asarray(data.flux_measured)),
        intercept=intercept,
        flux=flux,
    )


def plot_demo(prediction: dict[str, torch.Tensor], heliostat: str, output: pathlib.Path) -> pathlib.Path:
    """The demo's figure: each sample's cropped prediction over its measurement."""
    plt = _pyplot()
    predicted, measured = prediction["predicted"].cpu().numpy(), prediction["measured"].cpu().numpy()
    samples = predicted.shape[0]
    fig, axes = plt.subplots(2, samples, figsize=(4 * samples, 8), squeeze=False)
    for s in range(samples):
        axes[0][s].imshow(predicted[s], cmap="inferno")
        axes[0][s].set_title(f"predicted {s} (intercept {float(prediction['intercept'][s]):.2f})")
        axes[1][s].imshow(measured[s], cmap="inferno")
        axes[1][s].set_title(f"measured {s}")
    fig.suptitle(f"Flux prediction for {heliostat}")
    fig.tight_layout()
    output = pathlib.Path(output)
    output.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output, dpi=150)
    plt.close(fig)
    return output


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    commands = parser.add_subparsers(dest="command", required=True)
    results = commands.add_parser("results", help="the grid of flux_prediction_raytracing's results")
    results.add_argument("results_file", type=pathlib.Path)
    results.add_argument("--plots_dir", type=pathlib.Path, required=True)
    demo = commands.add_parser("demo", help="one heliostat's prediction against its measurements")
    demo.add_argument("data_dir", type=pathlib.Path)
    demo.add_argument("--output", type=pathlib.Path, required=True)
    demo.add_argument("--heliostat", default="AA39")
    demo.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    set_logger_config()
    if args.command == "results":
        output = plot_from_results(args.results_file, args.plots_dir)
    else:
        prediction = demo_prediction(
            demo_scenario(args.data_dir, args.heliostat, args.device), demo_mapping(args.data_dir, args.heliostat),
            device=args.device,
        )
        output = plot_demo(prediction, args.heliostat, args.output)
    print(f"plot written to {output}")
    return output


if __name__ == "__main__":
    main()
