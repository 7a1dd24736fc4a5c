"""The traffic generator: calibration samples for a field, from a workload's ``traffic`` block and the seed.

One generator for every cell; a workload file sets its parameters:

- ``samples_per_heliostat``: calibration samples of each heliostat, taken as its
  own consecutive block;
- ``calibration_hours_utc``, ``min_sun_elevation_deg``: when the samples are taken:
  a day of the year and a time of day (UTC) drawn uniformly, one per sample, the sun
  placed by solar geometry at the field's site (:func:`sun_directions`), and a time
  at which the sun stands lower than the minimum drawn again;
- ``deviation_mrad``: the range of each heliostat's rotation deviations (random
  signs; none where absent); ``dent_mm``: the range of each facet's interior
  control points' height offsets (none where absent);
- ``centred``: each image cropped around its centre of mass, as flux-centred
  calibration images are;
- ``spot_noise_m``: the standard deviation of the measured focal spots' error along
  each axis of the receiver (none where absent);
- ``cast_block``: the samples traced at once.

The flux is what the field casts with those deviations and dents, aimed at the
receiver's centre as if it had none, traced by the benchmark's reference with a
sun of its own.
Each sample's motor positions aim the ideal heliostat at the receiver's centre;
its focal spot is the centre of mass of its flux on the receiver. The arrays
are host numpy, as a calibration parser hands them to a reconstructor.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.field import reference_field
from benchmark.reference import geometry as geo
from benchmark.reference import render as rn


def sun_directions(day: np.ndarray, hour_utc: np.ndarray, latitude_deg: float, longitude_deg: float) -> np.ndarray:
    """Unit vectors ``[N, 3]`` (east, north, up) towards the sun on day of the year ``day``
    at ``hour_utc``, seen from the site: NOAA's general solar position (the fractional
    year's Fourier series of the declination and the equation of time)."""
    year = 2 * np.pi / 365 * (day - 1 + (hour_utc - 12) / 24)
    equation_of_time_min = 229.18 * (0.000075 + 0.001868 * np.cos(year) - 0.032077 * np.sin(year)
                                     - 0.014615 * np.cos(2 * year) - 0.040849 * np.sin(2 * year))
    declination = (0.006918 - 0.399912 * np.cos(year) + 0.070257 * np.sin(year) - 0.006758 * np.cos(2 * year)
                   + 0.000907 * np.sin(2 * year) - 0.002697 * np.cos(3 * year) + 0.00148 * np.sin(3 * year))
    solar_minutes = hour_utc * 60 + equation_of_time_min + 4 * longitude_deg
    hour_angle = np.deg2rad(solar_minutes / 4 - 180)
    latitude = np.deg2rad(latitude_deg)
    return np.stack([
        -np.cos(declination) * np.sin(hour_angle),
        np.cos(latitude) * np.sin(declination) - np.sin(latitude) * np.cos(declination) * np.cos(hour_angle),
        np.sin(latitude) * np.sin(declination) + np.cos(latitude) * np.cos(declination) * np.cos(hour_angle),
    ], axis=1)


def sun_incidence(rng: np.random.Generator, count: int, site: dict, hours_utc, min_elevation_deg: float) -> np.ndarray:
    """Incident ray directions ``[count, 4]`` of suns at the ``site`` (``latitude_deg``,
    ``longitude_deg``) on days and at times drawn uniformly over the year and ``hours_utc``;
    a time at which the sun stands below ``min_elevation_deg`` is drawn again."""
    kept: list[np.ndarray] = []
    while sum(len(part) for part in kept) < count:
        day = rng.integers(1, 366, 2 * count)
        hour = rng.uniform(*hours_utc, 2 * count)
        sun = sun_directions(day, hour, site["latitude_deg"], site["longitude_deg"])
        kept.append(sun[sun[:, 2] >= np.sin(np.deg2rad(min_elevation_deg))])
    sun = np.concatenate(kept)[:count]
    return np.concatenate([-sun, np.zeros((count, 1))], axis=1).astype(np.float32)


def known_deviations(rng: np.random.Generator, heliostats: int, magnitude_mrad) -> np.ndarray:
    """``[heliostats, 4]`` rotation deviations (rad) with random signs and magnitudes in the range."""
    signs = np.where(rng.random((heliostats, 4)) < 0.5, -1.0, 1.0)
    return (signs * rng.uniform(*magnitude_mrad, (heliostats, 4)) * 1e-3).astype(np.float32)


def dented(control_points: np.ndarray, rng: np.random.Generator, dent_mm) -> np.ndarray:
    """The control points with each facet's interior points raised or lowered by a height in ``dent_mm``."""
    out = control_points.copy()
    interior = out[:, :, 1:-1, 1:-1, 2]
    out[:, :, 1:-1, 1:-1, 2] = interior + rng.uniform(*dent_mm, interior.shape) * 1e-3 * np.where(
        rng.random(interior.shape) < 0.5, -1.0, 1.0)
    return out.astype(np.float32)


@torch.no_grad()
def calibration(arrays: dict, traffic: dict, seed: int, device) -> dict:
    """The calibration samples of every heliostat of the field ``arrays``
    (:func:`benchmark.field.field_arrays`): numpy ``flux`` ``[S, H, W]``, ``spots``,
    ``incident`` ``[S, 4]``, ``motors`` ``[S, 2]``, ``counts`` ``[heliostats]``,
    ``targets`` ``[S]``, and the ``deviations`` and ``control_points`` that cast the flux."""
    field = reference_field(arrays, device)
    heliostats = arrays["positions"].shape[0]
    per_heliostat = int(traffic["samples_per_heliostat"])
    count = heliostats * per_heliostat
    rng = np.random.default_rng([seed, 7])
    incident = sun_incidence(rng, count, arrays["site"], traffic["calibration_hours_utc"],
                             float(traffic["min_sun_elevation_deg"]))
    owner = torch.arange(heliostats, device=device).repeat_interleave(per_heliostat)
    incident_t = torch.as_tensor(incident, device=device)
    static, optimizable, positions = field["static"][owner], field["optimizable"][owner], field["positions"][owner]
    _, motors = geo.align_to_aim_points(positions, torch.zeros((count, 4), device=device), static, optimizable,
                                        incident_t, field["receiver"]["aim"].expand(count, 4))
    deviations = np.zeros((heliostats, 4), np.float32)
    if "deviation_mrad" in traffic:
        deviations = known_deviations(rng, heliostats, traffic["deviation_mrad"])
    control_points = arrays["control_points"]
    if "dent_mm" in traffic:
        control_points = dented(control_points, rng, traffic["dent_mm"])
    deviated = torch.as_tensor(deviations, device=device)[owner]
    surfaces = torch.as_tensor(control_points, device=device)[owner]
    grid = geo.evaluation_grid(*arrays["surface_points"], device=device)
    generator = torch.Generator(device=device).manual_seed(int(seed) + 1)
    maps = []
    for part in range(0, count, int(traffic["cast_block"])):
        part = slice(part, min(part + int(traffic["cast_block"]), count))
        index = owner[part]
        points, normals = geo.nurbs_surfaces(surfaces[part], field["canting"][index], field["translations"][index],
                                             grid, arrays["degree"])
        orientation = geo.motor_orientations(positions[part], deviated[part], static[part], optimizable[part],
                                             motors[part])
        points, normals = geo.orient(points, normals, orientation)
        scatter_u, scatter_e = rn.sun_distortions(generator, points.shape[0], arrays["rays"], points.shape[1],
                                                  arrays["covariance"])
        flux = rn.trace(points, normals, incident_t[part], scatter_u, scatter_e, field["receiver"],
                        arrays["resolution"])
        maps.append(rn.crop_around_center(flux, field["receiver"]) if traffic.get("centred") else flux)
    flux = torch.cat(maps)
    spots = rn.receiver_points(rn.centers_of_mass(flux), field["receiver"], arrays["resolution"])
    if "spot_noise_m" in traffic:
        noise = rng.normal(0.0, float(traffic["spot_noise_m"]), (count, 2)).astype(np.float32)
        spots = spots + torch.as_tensor(np.stack([noise[:, 0], np.zeros(count, np.float32), noise[:, 1]], axis=1),
                                        device=device)
    spots = torch.cat([spots, torch.ones_like(spots[:, :1])], dim=1)
    return dict(
        flux=flux.cpu().numpy(),
        spots=spots.cpu().numpy(),
        incident=incident,
        motors=motors.cpu().numpy(),
        counts=np.full(heliostats, per_heliostat, np.int32),
        targets=np.zeros(count, np.int32),
        deviations=deviations,
        control_points=control_points,
    )
