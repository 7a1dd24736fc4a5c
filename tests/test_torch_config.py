"""The port's scenario configuration schema and type registry against the JAX package's.

Each config is built in both packages from the same numpy values (a seed), and
its ``create_*_dict`` serialisation must be equal key by key: the same keys in
the same order, and values of the same Python type, dtype, shape and bits.
Tolerance: none; both are the same host numpy casts.
"""

import numpy as np
import pytest

from artist_tpu.util import config as jax_config
from artist_tpu.util import type_registry as jax_registry
from artist_tpu_torch.field import kinematics_rigid_body
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util import config, constants, type_registry


def assert_same_dict(ours, theirs, path="") -> None:
    """Equal nested dicts: keys in order, then each leaf's type, dtype, shape and bits."""
    assert isinstance(ours, dict) and isinstance(theirs, dict), path
    assert list(ours) == list(theirs), path
    for key in ours:
        mine, other = ours[key], theirs[key]
        where = f"{path}/{key}"
        if isinstance(other, dict):
            assert_same_dict(mine, other, where)
        elif isinstance(other, np.ndarray):
            assert isinstance(mine, np.ndarray), where
            assert mine.dtype == other.dtype and mine.shape == other.shape, where
            np.testing.assert_array_equal(mine, other, err_msg=where)
        else:
            assert type(mine) is type(other) and mine == other, where


def _values(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return dict(
        position=rng.uniform(-50, 50, 4),
        vector=rng.normal(size=4),
        control_points=rng.normal(size=(5, 4, 3)),
        canting=rng.normal(size=(2, 4)),
        floats=rng.uniform(0.1, 10.0, 16),
        motors=rng.randint(0, 100000, 2),
    )


def _build(module, seed: int) -> dict:
    """Every config class of ``module`` (either package's ``util/config.py``) from the seed's values."""
    v = _values(seed)
    f = v["floats"]
    facets = [
        module.FacetConfig(
            facet_key=f"facet_{i + 1}" if i else "",
            control_points=v["control_points"] + i,
            degrees=np.array([3, 2]),
            translation_vector=v["vector"] * i,
            canting=v["canting"] * (i + 1),
        )
        for i in range(3)
    ]
    surface = module.SurfaceConfig(facet_list=facets)
    deviations = module.KinematicsDeviations(*f[:13])
    kinematics = module.KinematicsConfig(
        kinematics_type=constants.rigid_body_key, initial_orientation=v["vector"], deviations=deviations
    )
    parameters = module.ActuatorParameters(*f[:5])
    actuators = module.ActuatorListConfig(
        actuator_list=[
            module.ActuatorConfig(
                actuator_key="" if i == 1 else f"actuator_{i}",
                actuator_type=constants.linear_actuator_key if i else constants.ideal_actuator_key,
                clockwise_axis_movement=bool(i),
                min_max_motor_positions=v["motors"],
                parameters=parameters if i else None,
            )
            for i in range(2)
        ]
    )
    return dict(
        power_plant=module.PowerPlantConfig(power_plant_position=v["position"][:3]).create_power_plant_dict(),
        planar=module.TargetAreaPlanarConfig("receiver", v["position"], v["vector"], f[0], f[1]).create_target_area_dict(),
        cylindrical=module.TargetAreaCylindricalConfig(
            "cylinder", v["position"], v["vector"], v["vector"] * 2, f[2], f[3], f[4]
        ).create_target_area_dict(),
        light_source=module.LightSourceConfig("sun_1", number_of_rays=17, mean=f[5], covariance=f[6]).create_light_source_dict(),
        light_source_defaults=module.LightSourceConfig("sun_2").create_light_source_dict(),
        facet=facets[1].create_facet_dict(),
        surface=surface.create_surface_dict(),
        deviations=deviations.create_kinematics_deviations_dict(),
        kinematics=kinematics.create_kinematics_dict(),
        kinematics_defaults=module.KinematicsConfig().create_kinematics_dict(),
        actuator_parameters=parameters.create_actuator_parameters_dict(),
        actuator=actuators.actuator_list[1].create_actuator_dict(),
        actuator_without_parameters=actuators.actuator_list[0].create_actuator_dict(),
        actuator_defaults=module.ActuatorConfig("a").create_actuator_dict(),
        actuators=actuators.create_actuator_list_dict(),
        prototype=module.PrototypeConfig(surface, kinematics, actuators).create_prototype_dict(),
        heliostat=module.HeliostatConfig("AA39", 3, v["position"], surface, kinematics, actuators).create_heliostat_dict(),
        heliostat_prototype_only=module.HeliostatConfig("AB40", 4, v["position"]).create_heliostat_dict(),
    )


CASES = sorted(_build(config, 0))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_config_dicts_equal_jax(case, seed):
    assert_same_dict(_build(config, seed)[case], _build(jax_config, seed)[case], case)


def test_config_schema_matches_jax():
    """The same dataclasses, fields and defaults, and the prototype aliases."""
    names = [n for n in dir(jax_config) if n.endswith("Config") or n in ("KinematicsDeviations", "ActuatorParameters")]
    assert names and all(hasattr(config, n) for n in names)
    for name in names:
        ours, theirs = getattr(config, name), getattr(jax_config, name)
        assert list(ours.__dataclass_fields__) == list(theirs.__dataclass_fields__), name
    assert config.SurfacePrototypeConfig is config.SurfaceConfig
    assert config.KinematicsPrototypeConfig is config.KinematicsConfig
    assert config.ActuatorPrototypeConfig is config.ActuatorListConfig
    assert config.ActuatorConfig("a").parameters is None and config.HeliostatConfig("h", 0, np.zeros(4)).surface is None


def test_type_registry_maps_onto_the_port():
    assert list(type_registry.heliostat_group_type_mapping) == list(jax_registry.heliostat_group_type_mapping)
    assert all(m is kinematics_rigid_body for m in type_registry.heliostat_group_type_mapping.values())
    assert type_registry.actuator_type_mapping == jax_registry.actuator_type_mapping
    assert list(type_registry.light_source_type_mapping) == list(jax_registry.light_source_type_mapping)
    assert type_registry.light_source_type_mapping[constants.sun_key] is Sun
