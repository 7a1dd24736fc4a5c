"""Tutorial 01: align a single heliostat and render its flux bitmap.

Counterpart of ``tutorials/01_single_heliostat_raytracing.py``::

    python -m artist_tpu_torch.tutorials.single_heliostat_raytracing --scenario PATH [--device cuda] [--plot PNG]

The scenario file is read with ``h5py`` and the optional plot written with
``matplotlib``; :func:`render_single_heliostat` needs neither.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util.logging_utils import set_logger_config

SURFACE_POINTS = (50, 50)
BITMAP = (256, 256)
SEED = 7
SOUTH = (0.0, 1.0, 0.0, 0.0)


def render_single_heliostat(
    scenario: Scenario,
    distortions: tuple[torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    bitmap_resolution: tuple[int, int] = BITMAP,
    device: torch.device | str = "cuda",
) -> dict:
    """The first heliostat of the first group, activated once, aligned to target 0's
    centre with the sun in the south, and traced onto ``bitmap_resolution``.

    The sun's distortions are ``distortions`` (``[1, R, P]`` each), or drawn from
    ``generator`` (by default one seeded with :data:`SEED` on ``device``). Returns
    the flux ``[1, height, width]``, the intercept, on-target and blocking factors,
    the solved motor positions ``[1, 2]`` and the heliostat's name.
    """
    device = torch.device(device)
    scenario.to(device)
    group = scenario.heliostat_groups[0]
    active = hg.gather_active(
        group, torch.as_tensor(hg.active_indices_from_mask(np.array([1], np.int32)), device=device)
    )
    target_area_indices = torch.zeros(1, dtype=torch.long, device=device)
    incident_ray_directions = torch.tensor([SOUTH], dtype=torch.float32, device=device)
    aim_points = get_centers_of_target_areas(scenario.solar_tower, target_area_indices)
    points, normals, _, motor_positions = hg.align_surfaces_with_incident_ray_directions(
        active, aim_points, incident_ray_directions
    )
    if distortions is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(SEED)
        distortions = scenario.light_sources[0].get_distortions(generator, points.shape[1], 1)
    distortions_u, distortions_e = (torch.as_tensor(d, device=device) for d in distortions)
    flux, intercept, on_target, blocking = trace_rays(
        tower=scenario.solar_tower,
        aligned_surface_points=points,
        aligned_surface_normals=normals,
        incident_ray_directions=incident_ray_directions,
        target_area_indices=target_area_indices,
        distortions_u=distortions_u,
        distortions_e=distortions_e,
        config=RenderConfig(bitmap_resolution=bitmap_resolution),
    )
    return dict(
        flux=flux,
        intercept=intercept,
        on_target=on_target,
        blocking=blocking,
        motor_positions=motor_positions,
        name=group.names[0],
    )


def save_flux_plot(flux: np.ndarray, title: str, path) -> None:
    """The flux map as a PNG (needs ``matplotlib``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figure = plt.figure()
    plt.imshow(flux, cmap="inferno")
    plt.title(title)
    plt.colorbar()
    figure.savefig(path, dpi=150)
    plt.close(figure)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", required=True, help="scenario HDF5 file with one heliostat")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--plot", help="write the flux map to this PNG (needs matplotlib)")
    args = parser.parse_args(argv)
    set_logger_config()
    scenario = load_scenario_from_hdf5(
        args.scenario, number_of_surface_points_per_facet=SURFACE_POINTS, device=args.device
    )
    group = scenario.heliostat_groups[0]
    print(f"The light source is a {type(scenario.light_sources[0]).__name__}.")
    print(f"Target index mapping: {scenario.solar_tower.target_name_to_index}.")
    print(f"The first heliostat is {group.names[0]} at {group.positions[0].tolist()}.")
    result = render_single_heliostat(scenario, device=args.device)
    print(f"Solved motor positions: {result['motor_positions'].cpu().numpy()}")
    print(
        f"Total flux {float(result['flux'].sum()):.1f}, intercept factor {float(result['intercept'][0]):.3f}, "
        f"on-target factor {float(result['on_target'][0]):.3f}"
    )
    if args.plot:
        save_flux_plot(result["flux"][0].cpu().numpy(), f"Flux of {result['name']}", args.plot)
        print(f"Flux image saved to {args.plot}.")
    return result


if __name__ == "__main__":
    main()
