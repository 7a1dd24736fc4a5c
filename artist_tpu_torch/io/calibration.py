"""Calibration data of one heliostat group, as the inverse problems read it.

Counterpart of ``CalibrationData`` in ``artist_tpu/io/calibration.py``: host
numpy arrays, per calibration sample ``S`` and per heliostat ``H``. The
samples are ordered blocks, heliostat ``h`` owning
``active_heliostats_mask[h]`` consecutive samples. The PAINT parser that
fills it from files is not ported yet;
:class:`~artist_tpu_torch.scenario.synthetic.SyntheticCalibrationParser`
fills it in memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CalibrationData:
    """Parsed calibration measurements for one heliostat group."""

    flux_measured: np.ndarray  # [S, H, W]
    focal_spots: np.ndarray  # [S, 4] local ENU homogeneous
    incident_ray_directions: np.ndarray  # [S, 4]
    motor_positions: np.ndarray  # [S, 2]
    active_heliostats_mask: np.ndarray  # [H] multiplicity
    target_area_indices: np.ndarray  # [S]
