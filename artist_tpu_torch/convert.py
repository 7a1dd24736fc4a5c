"""Carry scene state into the port from numpy arrays.

Each function takes dicts of numpy arrays keyed by the field names of the
JAX package's dataclasses (``HeliostatGroupState``, ``SolarTower``, ``Sun``,
``Scenario``), so a caller holding that state writes
``{f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}``
and both packages then compute from the same parameters. Nothing here
imports the JAX package: the dicts are plain data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artist_tpu_torch.field.heliostat_group import HeliostatGroupState
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.scene.sun import Sun

_GROUP_METADATA = ("names", "kinematics_type", "actuator_type", "nurbs_degrees")
_TOWER_METADATA = ("planar_names", "cylindrical_names")


def _tensor(value, device) -> torch.Tensor:
    return torch.tensor(np.asarray(value, dtype=np.float32), device=device)


def _names(value) -> tuple[str, ...]:
    return tuple(str(name) for name in np.asarray(value).reshape(-1))


def group_from_numpy(d: dict, device: torch.device | str = "cuda") -> HeliostatGroupState:
    """A :class:`HeliostatGroupState` on ``device`` from a dict of numpy arrays."""
    tensors = {
        f.name: _tensor(d[f.name], device)
        for f in dataclasses.fields(HeliostatGroupState)
        if f.name not in _GROUP_METADATA
    }
    return HeliostatGroupState(
        **tensors,
        names=_names(d["names"]),
        kinematics_type=str(np.asarray(d["kinematics_type"])),
        actuator_type=str(np.asarray(d["actuator_type"])),
        nurbs_degrees=tuple(int(x) for x in np.asarray(d["nurbs_degrees"]).reshape(-1)),
    )


def tower_from_numpy(d: dict, device: torch.device | str = "cuda") -> SolarTower:
    """A :class:`SolarTower` on ``device`` from a dict of numpy arrays."""
    tensors = {
        f.name: _tensor(d[f.name], device)
        for f in dataclasses.fields(SolarTower)
        if f.name not in _TOWER_METADATA
    }
    return SolarTower(
        **tensors,
        planar_names=_names(d["planar_names"]),
        cylindrical_names=_names(d["cylindrical_names"]),
    )


def _plain(value):
    """A Python object from a 0-d numpy object array (``np.asarray(dict)``)."""
    return value.item() if isinstance(value, np.ndarray) else value


def scenario_from_numpy(
    power_plant_position: np.ndarray,
    solar_tower: dict,
    light_sources: list[dict],
    heliostat_groups: list[dict],
    heliostat_group_names: list[str] = (),
    device: torch.device | str = "cuda",
) -> Scenario:
    """A :class:`Scenario` on ``device``.

    ``solar_tower`` and each of ``heliostat_groups`` are dicts as for
    :func:`tower_from_numpy` and :func:`group_from_numpy`; each of
    ``light_sources`` holds a sun's ``number_of_rays`` and
    ``distribution_parameters``.
    """
    return Scenario(
        power_plant_position=np.asarray(power_plant_position, dtype=np.float64),
        solar_tower=tower_from_numpy(solar_tower, device),
        light_sources=[
            Sun(
                number_of_rays=int(sun["number_of_rays"]),
                distribution_parameters=dict(_plain(sun["distribution_parameters"])),
            )
            for sun in light_sources
        ],
        heliostat_groups=[group_from_numpy(g, device) for g in heliostat_groups],
        heliostat_group_names=list(heliostat_group_names),
    )
