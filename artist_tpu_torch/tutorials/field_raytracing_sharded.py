"""Tutorial 02: field-level ray tracing split over processes.

Counterpart of ``tutorials/02_field_raytracing_sharded.py``. The JAX script shards
the active-sample axis over a device mesh's ``heliostats`` axis and the ray axis
over its ``rays`` axis, and lets XLA insert the sums. Here a
``torch.distributed`` mesh (:func:`artist_tpu_torch.parallel.make_mesh`, one
process a rank) splits the same axes: each rank traces its samples' share of the
rays, the ray shares' maps are summed and the samples' gathered. Without a mesh
the world is one process and no process group is needed::

    python -m artist_tpu_torch.tutorials.field_raytracing_sharded --scenario PATH [--device cuda]

:func:`render_field` takes the mesh of a caller's process group
(``setup_distributed_environment(...).mesh``); the command runs one process. The
scenario file is read with ``h5py``; :func:`render_field` needs none.
"""

from __future__ import annotations

import argparse

import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.parallel import collectives
from artist_tpu_torch.parallel.mesh import (
    MESH_DIMS,
    fetch_global,
    put_global,
    ray_sharding,
    sample_sharding,
    shard_count,
)
from artist_tpu_torch.raytracing.render import RenderConfig, get_bitmaps_per_target, trace_rays
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util.logging_utils import set_logger_config

SURFACE_POINTS = (25, 25)
BITMAP = (256, 256)
SEED = 7
SOUTH = (0.0, 1.0, 0.0, 0.0)


def _trace_shard(scenario: Scenario, points, normals, incident, targets, distortions, bitmap, mesh):
    """This rank's share of the trace, summed over the ray shards and gathered over the
    sample shards: the flux ``[M, height, width]`` and intercept factors ``[M]``."""
    samples = sample_sharding(mesh)
    distortions_u, distortions_e = (put_global(d, ray_sharding(mesh)) for d in distortions)
    flux, intercept, _, _ = trace_rays(
        tower=scenario.solar_tower,
        aligned_surface_points=put_global(points, samples),
        aligned_surface_normals=put_global(normals, samples),
        incident_ray_directions=put_global(incident, samples),
        target_area_indices=put_global(targets, samples),
        distortions_u=distortions_u,
        distortions_e=distortions_e,
        config=RenderConfig(bitmap_resolution=bitmap),
    )
    ray_shards = shard_count(mesh, MESH_DIMS[1], distortions[0].shape[1])
    if ray_shards > 1:
        group = mesh.get_group(MESH_DIMS[1])
        flux = collectives.all_reduce_tensor(flux, group)
        intercept = collectives.all_reduce_tensor(intercept, group) / ray_shards
    return (
        fetch_global(flux, samples, (points.shape[0], *flux.shape[1:])),
        fetch_global(intercept, samples, (points.shape[0],)),
    )


def render_field(
    scenario: Scenario,
    distortions: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
    mesh=None,
    bitmap_resolution: tuple[int, int] = BITMAP,
    device: torch.device | str = "cuda",
) -> dict:
    """Every heliostat of every group aimed at target 0's centre with the sun in the
    south, traced, and summed per target.

    Each group's active-sample axis is padded to a multiple of the mesh's
    ``heliostats`` size by repeating its last heliostat, so the shards stay equal
    (the padding is dropped before the sums). ``distortions`` holds one ``[padded, R,
    P]`` pair a group; by default group ``g``'s are drawn from a generator seeded with
    ``SEED + g`` on ``device``. ``mesh`` (a ``DeviceMesh`` of
    :func:`artist_tpu_torch.parallel.make_mesh`) splits the samples and the rays over
    the ranks; None traces everything in this process.

    Returns the flux per target ``[T, height, width]``, each group's mean intercept
    factor and heliostat count.
    """
    device = torch.device(device)
    scenario.to(device)
    shards = 1 if mesh is None else mesh.size(MESH_DIMS.index("heliostats"))
    tower = scenario.solar_tower
    total_flux_per_target = torch.zeros((tower.number_of_target_areas, bitmap_resolution[1], bitmap_resolution[0]),
                                        device=device)
    mean_intercepts, heliostats = [], []
    for group_index, group in enumerate(scenario.heliostat_groups):
        num = group.number_of_heliostats
        padded = -(-num // shards) * shards
        active = hg.gather_active(group, torch.arange(padded, device=device).clamp(max=num - 1))
        targets = torch.zeros(padded, dtype=torch.long, device=device)
        incident = torch.tensor(SOUTH, device=device).expand(padded, 4)
        points, normals, _, _ = hg.align_surfaces_with_incident_ray_directions(
            active, get_centers_of_target_areas(tower, targets), incident
        )
        if distortions is None:
            generator = torch.Generator(device=device).manual_seed(SEED + group_index)
            group_distortions = scenario.light_sources[0].get_distortions(generator, points.shape[1], padded)
        else:
            group_distortions = tuple(torch.as_tensor(d, device=device) for d in distortions[group_index])
        flux, intercept = _trace_shard(
            scenario, points, normals, incident.contiguous(), targets, group_distortions, bitmap_resolution, mesh
        )
        total_flux_per_target += get_bitmaps_per_target(flux[:num], targets[:num], tower.number_of_target_areas)
        mean_intercepts.append(float(intercept[:num].mean()))
        heliostats.append(num)
    return dict(total_flux_per_target=total_flux_per_target, mean_intercepts=mean_intercepts, heliostats=heliostats)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", required=True, help="scenario HDF5 file")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    scenario = load_scenario_from_hdf5(
        args.scenario, number_of_surface_points_per_facet=SURFACE_POINTS, device=args.device
    )
    result = render_field(scenario, device=args.device)
    print(f"Mesh: (1, 1) axes {MESH_DIMS} (one process)")
    for index, (count, intercept) in enumerate(zip(result["heliostats"], result["mean_intercepts"])):
        print(f"Group {index}: {count} heliostats, mean intercept {intercept:.3f}")
    print("Total flux per target:", result["total_flux_per_target"].sum(dim=(1, 2)).cpu().numpy())
    return result


if __name__ == "__main__":
    main()
