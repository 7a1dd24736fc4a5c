"""String -> implementation registries for scenario loading.

Counterpart of ``artist_tpu/util/type_registry.py``. The runtime state is
functional (no class per kinematics and actuator combination), so the
registries map the schema's type strings onto the port's module-level
implementations.
"""

from __future__ import annotations

from artist_tpu_torch.field import kinematics_rigid_body
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util import constants

# f"{kinematics_type}_{actuator_type}" -> kinematics module implementing the
# forward and inverse solves for that group type.
heliostat_group_type_mapping = {
    f"{constants.rigid_body_key}_{constants.linear_actuator_key}": kinematics_rigid_body,
    f"{constants.rigid_body_key}_{constants.ideal_actuator_key}": kinematics_rigid_body,
}

# Actuator type int (HDF5 schema) -> type string.
actuator_type_mapping = {
    constants.linear_actuator_int: constants.linear_actuator_key,
    constants.ideal_actuator_int: constants.ideal_actuator_key,
}

# Light source type string -> implementation.
light_source_type_mapping = {
    constants.sun_key: Sun,
}
