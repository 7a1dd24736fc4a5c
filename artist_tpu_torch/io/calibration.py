"""Calibration data ingress: PAINT JSON properties and flux PNG images.

Counterpart of ``artist_tpu/io/calibration.py``: host numpy. The
:class:`CalibrationData` container is what the inverse problems read;
:class:`PaintCalibrationDataParser` fills it from PAINT files and
:class:`~artist_tpu_torch.scenario.synthetic.SyntheticCalibrationParser` in
memory. ``PIL`` is imported only by :func:`load_flux_from_png`, which resizes
with PIL's bilinear filter as the JAX package does.
"""

from __future__ import annotations

import json
import logging
import pathlib
from collections import Counter, defaultdict
from dataclasses import dataclass

import numpy as np

from artist_tpu_torch.geometry.coordinates import convert_wgs84_coordinates_to_local_enu
from artist_tpu_torch.util import indices

log = logging.getLogger("artist_tpu_torch.io")

# PAINT calibration-properties JSON keys (PAINT database schema).
PAINT_MOTOR_POS_KEY = "motor_position"
PAINT_AXIS1_MOTOR = "axis_1_motor_position"
PAINT_AXIS2_MOTOR = "axis_2_motor_position"
PAINT_TARGET_NAME_KEY = "target_name"
PAINT_SUN_AZIMUTH = "sun_azimuth"
PAINT_SUN_ELEVATION = "sun_elevation"
PAINT_FOCAL_SPOT_KEY = "focal_spot"
PAINT_UTIS_KEY = "UTIS"
PAINT_HELIOS_KEY = "HeliOS"


def load_flux_from_png(
    heliostat_flux_path_mapping: list[tuple[str, list[pathlib.Path]]],
    heliostat_names: tuple[str, ...],
    resolution: tuple[int, int] = (indices.bitmap_resolution, indices.bitmap_resolution),
    sample_limit: int | None = None,
) -> np.ndarray:
    """Load grayscale flux PNG files, resized and normalized to [0, 1].

    Raises ``ImportError`` where ``PIL`` is not installed.

    Returns
    -------
    np.ndarray
        Shape ``[total_samples, height, width]`` float32.
    """
    from PIL import Image

    width, height = int(resolution[0]), int(resolution[1])
    path_mapping = dict(heliostat_flux_path_mapping)

    fluxes = []
    for heliostat_name in heliostat_names:
        paths = path_mapping.get(heliostat_name, [])
        limit = min(len(paths), sample_limit or len(paths))
        for path in paths[:limit]:
            image = Image.open(path).convert("L")
            if image.size != (width, height):
                image = image.resize((width, height), Image.Resampling.BILINEAR)
            fluxes.append(
                np.asarray(image, dtype=np.float32) / indices.bitmap_normalizer
            )
    if not fluxes:
        return np.empty((0, height, width), dtype=np.float32)
    return np.stack(fluxes)


@dataclass
class CalibrationData:
    """Parsed calibration measurements for one heliostat group."""

    flux_measured: np.ndarray  # [S, H, W]
    focal_spots: np.ndarray  # [S, 4] local ENU homogeneous
    incident_ray_directions: np.ndarray  # [S, 4]
    motor_positions: np.ndarray  # [S, 2]
    active_heliostats_mask: np.ndarray  # [H] multiplicity
    target_area_indices: np.ndarray  # [S]


class PaintCalibrationDataParser:
    """PAINT calibration-properties parser."""

    def __init__(
        self,
        sample_limit: int | None = None,
        centroid_extraction_method: str = PAINT_UTIS_KEY,
    ) -> None:
        if centroid_extraction_method not in (PAINT_UTIS_KEY, PAINT_HELIOS_KEY):
            raise ValueError(
                f"The selected centroid extraction method "
                f"{centroid_extraction_method} is not yet supported. Please use "
                f"either {PAINT_UTIS_KEY} or {PAINT_HELIOS_KEY}!"
            )
        self.sample_limit = sample_limit
        self.centroid_extraction_method = centroid_extraction_method

    def parse_data_for_reconstruction(
        self,
        heliostat_data_mapping: list[
            tuple[str, list[pathlib.Path], list[pathlib.Path]]
        ],
        heliostat_names: tuple[str, ...],
        target_name_to_index: dict[str, int],
        power_plant_position: np.ndarray,
        bitmap_resolution: tuple[int, int] = (
            indices.bitmap_resolution,
            indices.bitmap_resolution,
        ),
    ) -> CalibrationData:
        """Extract measured fluxes and calibration properties.

        Parameters
        ----------
        heliostat_data_mapping : list
            Tuples (heliostat_name, properties_json_paths, flux_png_paths).
        heliostat_names : tuple[str, ...]
            Names of heliostats in the group (defines sample ordering).
        target_name_to_index : dict
            Global target index mapping.
        power_plant_position : np.ndarray
            WGS84 reference point. Shape ``[3]``.
        """
        flux_mapping = [
            (name, pngs)
            for name, _props, pngs in heliostat_data_mapping
            if name in heliostat_names
        ]
        calibration_mapping = [
            (name, props)
            for name, props, _pngs in heliostat_data_mapping
            if name in heliostat_names
        ]

        flux = load_flux_from_png(
            flux_mapping, heliostat_names, bitmap_resolution, self.sample_limit
        )

        replication_counter: Counter[str] = Counter()
        per_heliostat = defaultdict(list)
        for heliostat_name, paths in calibration_mapping:
            limit = min(len(paths), self.sample_limit or len(paths))
            for path in paths[:limit]:
                with open(path) as f:
                    data = json.load(f)
                replication_counter[heliostat_name] += 1
                per_heliostat[heliostat_name].append(
                    (
                        target_name_to_index[data[PAINT_TARGET_NAME_KEY]],
                        data[PAINT_FOCAL_SPOT_KEY][self.centroid_extraction_method],
                        data[PAINT_SUN_AZIMUTH],
                        data[PAINT_SUN_ELEVATION],
                        [
                            data[PAINT_MOTOR_POS_KEY][PAINT_AXIS1_MOTOR],
                            data[PAINT_MOTOR_POS_KEY][PAINT_AXIS2_MOTOR],
                        ],
                    )
                )

        mask = np.array(
            [replication_counter[name] for name in heliostat_names], dtype=np.int32
        )
        total = int(mask.sum())

        target_indices = np.empty(total, dtype=np.int32)
        focal_spots_wgs84 = np.empty((total, 3), dtype=np.float64)
        azimuths = np.empty(total, dtype=np.float64)
        elevations = np.empty(total, dtype=np.float64)
        motor_positions = np.empty((total, 2), dtype=np.float32)

        index = 0
        for name in heliostat_names:
            for target, focal_spot, azimuth, elevation, motors in per_heliostat.get(
                name, []
            ):
                target_indices[index] = target
                focal_spots_wgs84[index] = focal_spot
                azimuths[index] = azimuth
                elevations[index] = elevation
                motor_positions[index] = motors
                index += 1

        focal_spots_enu = convert_wgs84_coordinates_to_local_enu(
            focal_spots_wgs84, power_plant_position
        )
        focal_spots = np.concatenate(
            [focal_spots_enu, np.ones((total, 1), dtype=np.float32)], axis=1
        )

        # Incident ray directions: origin minus the unit light-source position
        # from (south-oriented) azimuth/elevation.
        azimuth_rad = np.deg2rad(azimuths)
        elevation_rad = np.deg2rad(elevations)
        light_positions = np.stack(
            [
                np.cos(elevation_rad) * np.sin(azimuth_rad),
                -np.cos(elevation_rad) * np.cos(azimuth_rad),
                np.sin(elevation_rad),
            ],
            axis=1,
        ).astype(np.float32)
        incident = np.concatenate(
            [-light_positions, np.ones((total, 1), dtype=np.float32)], axis=1
        )
        # The origin point (w=1) minus the homogeneous light position (a point,
        # w=1): the w components cancel to 0.
        incident[:, 3] = 0.0

        log.info("Loading calibration properties data complete.")
        return CalibrationData(
            flux_measured=flux,
            focal_spots=focal_spots,
            incident_ray_directions=incident,
            motor_positions=motor_positions,
            active_heliostats_mask=mask,
            target_area_indices=target_indices,
        )
