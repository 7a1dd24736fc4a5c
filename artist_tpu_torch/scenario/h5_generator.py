"""Scenario HDF5 writer.

Counterpart of ``artist_tpu/scenario/h5_generator.py``: the same
flattened-key layout, keys and dtypes, so either package loads the other's
files. ``h5py`` is imported only by :meth:`H5ScenarioGenerator.generate_scenario`;
:meth:`H5ScenarioGenerator.scenario_image` gives the same content as a nested dict,
which ``scenario.load_scenario_from_image`` loads without a file.
"""

from __future__ import annotations

import logging
import pathlib
from collections.abc import MutableMapping
from typing import Any

from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import (
    ActuatorListConfig,
    HeliostatListConfig,
    KinematicsConfig,
    LightSourceListConfig,
    PowerPlantConfig,
    PrototypeConfig,
    TargetAreaCylindricalConfig,
    TargetAreaPlanarConfig,
)

log = logging.getLogger("artist_tpu_torch.scenario")


def _flatten(dictionary: MutableMapping[str, Any], parent_key: str = "", sep: str = "/"):
    """Flatten nested dicts into slash-joined keys (HDF5 dataset paths)."""
    items: dict[str, Any] = {}
    for key, value in dictionary.items():
        new_key = f"{parent_key}{sep}{key}" if parent_key else key
        if isinstance(value, MutableMapping):
            items.update(_flatten(value, new_key, sep))
        else:
            items[new_key] = value
    return items


class H5ScenarioGenerator:
    """Write a scenario configuration to an HDF5 file."""

    def __init__(
        self,
        file_path: pathlib.Path | str,
        power_plant_config: PowerPlantConfig,
        target_area_list_planar_config: list[TargetAreaPlanarConfig],
        target_area_list_cylindrical_config: list[TargetAreaCylindricalConfig],
        light_source_list_config: LightSourceListConfig,
        heliostat_list_config: HeliostatListConfig,
        prototype_config: PrototypeConfig,
        version: float = 1.0,
    ) -> None:
        self.file_path = pathlib.Path(file_path)
        if not self.file_path.parent.is_dir():
            raise FileNotFoundError(
                f"The folder ``{self.file_path.parent}`` selected to save the "
                f"scenario does not exist. Please create the folder or adjust "
                f"the file path before running again!"
            )
        self.power_plant_config = power_plant_config
        self.target_area_list_planar_config = target_area_list_planar_config
        self.target_area_list_cylindrical_config = target_area_list_cylindrical_config
        self.light_source_list_config = light_source_list_config
        self.heliostat_list_config = heliostat_list_config
        self.prototype_config = prototype_config
        self.version = version
        self._check_equal_facet_numbers()

    def _check_equal_facet_numbers(self) -> None:
        """Every heliostat must have the prototype's facet count."""
        accepted = len(self.prototype_config.surface_prototype.facet_list)
        for heliostat in self.heliostat_list_config.heliostat_list:
            if heliostat.surface is not None:
                if len(heliostat.surface.facet_list) != accepted:
                    raise ValueError(
                        "Individual heliostats must all have the same number of facets!"
                    )

    def _get_number_of_heliostat_groups(self) -> int:
        """Count unique (kinematics, actuator) type combinations."""
        unique_groups = set()
        for heliostat in self.heliostat_list_config.heliostat_list:
            if isinstance(heliostat.kinematics, KinematicsConfig):
                kinematics_type = heliostat.kinematics.kinematics_type
            else:
                kinematics_type = (
                    self.prototype_config.kinematics_prototype.kinematics_type
                )
            if isinstance(heliostat.actuators, ActuatorListConfig):
                actuator_list = heliostat.actuators.actuator_list
            else:
                actuator_list = self.prototype_config.actuators_prototype.actuator_list
            for actuator in actuator_list:
                unique_groups.add((kinematics_type, actuator.actuator_type))
        return len(unique_groups)

    def scenario_image(self) -> dict[str, Any]:
        """The scenario file's content as a nested dict of host values: a dict is an
        HDF5 group, anything else a dataset."""
        return {
            constants.number_of_heliostat_groups: self._get_number_of_heliostat_groups(),
            constants.power_plant_key: self.power_plant_config.create_power_plant_dict(),
            constants.target_area_planar_key: {
                t.target_area_key: t.create_target_area_dict() for t in self.target_area_list_planar_config
            },
            constants.target_area_cylindrical_key: {
                t.target_area_key: t.create_target_area_dict() for t in self.target_area_list_cylindrical_config
            },
            constants.light_source_key: {
                s.light_source_key: s.create_light_source_dict()
                for s in self.light_source_list_config.light_source_list
            },
            constants.prototype_key: self.prototype_config.create_prototype_dict(),
            constants.heliostat_key: {
                h.name: h.create_heliostat_dict() for h in self.heliostat_list_config.heliostat_list
            },
        }

    def generate_scenario(self) -> pathlib.Path:
        """Generate the scenario and save it as an HDF5 file.

        Raises ``ImportError`` where ``h5py`` is not installed.
        """
        import h5py

        log.info("Generating a scenario saved to: %s.", self.file_path)
        if self.file_path.suffix == ".h5":
            save_name = self.file_path
        elif self.file_path.suffix == "":
            save_name = self.file_path.with_suffix(".h5")
        else:
            log.warning(
                "Only HDF5 files are supported in the scenario generator; the "
                "extension %s is unsupported. A .h5 file will be produced instead.",
                self.file_path.suffix,
            )
            save_name = self.file_path.with_suffix(".h5")
        image = self.scenario_image()
        with h5py.File(save_name, "w") as f:
            f.attrs["version"] = self.version
            # Both target-area groups exist even when empty: a loader may
            # open them unconditionally.
            f.require_group(constants.target_area_planar_key)
            f.require_group(constants.target_area_cylindrical_key)
            for key, value in _flatten(image).items():
                f[key] = value
        log.info("Scenario generation complete.")
        return save_name
