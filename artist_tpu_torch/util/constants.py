"""String keys of the scenario HDF5 schema and optimization-config dicts.

These constants define the on-disk scenario format shared with the reference
implementation (reference: artist/util/constants.py:1-329) so that existing
scenario ``.h5`` files load unchanged. They are data-format identifiers, not
code: the values are fixed by the HDF5 schema.
"""

# --- power plant -----------------------------------------------------------
power_plant_key = "power_plant"
power_plant_position = "position"

# --- tower target areas ----------------------------------------------------
target_area_planar_key = "target_areas_planar"
target_area_cylindrical_key = "target_areas_cylindrical"
target_area_position_center = "position_center"
target_area_normal_vector = "normal_vector"
target_area_plane_e = "plane_e"
target_area_plane_u = "plane_u"
target_area_receiver = "receiver"
target_area_cylinder_radius = "cylinder_radius"
target_area_cylinder_center = "cylinder_center"
target_area_cylinder_height = "cylinder_height"
target_area_cylinder_axis = "cylinder_axis"
target_area_cylinder_normal = "cylinder_normal"
target_area_cylinder_opening_angle = "cylinder_opening_angle"

# --- light sources ---------------------------------------------------------
light_source_key = "lightsources"
light_source_type = "type"
sun_key = "sun"
light_source_number_of_rays = "number_of_rays"
light_source_distribution_parameters = "distribution_parameters"
light_source_distribution_type = "distribution_type"
light_source_distribution_is_normal = "normal"
light_source_mean = "mean"
light_source_covariance = "covariance"

# --- surfaces / facets -----------------------------------------------------
facets_key = "facets"
facet_control_points = "control_points"
facet_degrees = "degrees"
facets_translation_vector = "position"
facets_canting = "canting"
facet_translations = "facet_translations"

# --- kinematics ------------------------------------------------------------
kinematics_type = "type"
rigid_body_key = "rigid_body"
rigid_body_number_of_translation_deviation_parameters = 9
rigid_body_number_of_rotation_deviation_parameters = 4
rigid_body_number_of_actuators = 2
kinematics_initial_orientation = "initial_orientation"
kinematics_deviations = "deviations"
translation_deviations = "translation_deviations"
rotation_deviations = "rotation_deviations"

first_joint_translation_e = "first_joint_translation_e"
first_joint_translation_n = "first_joint_translation_n"
first_joint_translation_u = "first_joint_translation_u"
first_joint_tilt_n = "first_joint_tilt_n"
first_joint_tilt_u = "first_joint_tilt_u"
second_joint_translation_e = "second_joint_translation_e"
second_joint_translation_n = "second_joint_translation_n"
second_joint_translation_u = "second_joint_translation_u"
second_joint_tilt_e = "second_joint_tilt_e"
second_joint_tilt_n = "second_joint_tilt_n"
concentrator_translation_e = "concentrator_translation_e"
concentrator_translation_n = "concentrator_translation_n"
concentrator_translation_u = "concentrator_translation_u"

# --- actuators --------------------------------------------------------------
actuator_type_key = "type"
actuator_parameters_key = "parameters"
ideal_actuator_key = "ideal"
ideal_actuator_int = 1
linear_actuator_key = "linear"
linear_actuator_int = 0
actuator_clockwise_axis_movement = "clockwise_axis_movement"
actuator_increment = "increment"
actuator_min_max_motor_positions = "min_max_motor_positions"
actuator_initial_stroke_length = "initial_stroke_length"
actuator_offset = "offset"
actuator_pivot_radius = "pivot_radius"
actuator_initial_angle = "initial_angle"

# --- prototypes / heliostats -------------------------------------------------
prototype_key = "prototypes"
surface_prototype_key = "surface"
kinematics_prototype_key = "kinematics"
actuators_prototype_key = "actuator"
heliostat_key = "heliostats"
heliostat_id = "id"
heliostat_position = "position"
heliostat_surface_key = "surface"
heliostat_kinematics_key = "kinematics"
heliostat_actuator_key = "actuator"
number_of_heliostat_groups = "number_of_heliostat_groups"

# --- group assembly keys (in-memory grouping) --------------------------------
names = "names"
positions = "positions"
surface_points = "surface_points"
surface_normals = "surface_normals"
initial_orientations = "initial_orientations"
actuator_parameters_non_optimizable = "actuator_parameters_non_optimizable"
actuator_parameters_optimizable = "actuator_parameters_optimizable"
heliostat_group_type = "type"

# --- NURBS fitting modes ------------------------------------------------------
fit_nurbs_from_points = "point_cloud"
fit_nurbs_from_normals = "deflectometry"

# --- kinematics reconstruction methods ---------------------------------------
kinematics_reconstruction_raytracing = "raytracing"
kinematics_reconstruction_alignment = "alignment"

# --- UTIS crop (physical window size in meters) ------------------------------
utis_crop_width = 6
utis_crop_height = 6

# --- data parser keys ---------------------------------------------------------
data_parser = "data_parser"
heliostat_data_mapping = "heliostat_data_mapping"

# --- optimization config keys --------------------------------------------------
optimization = "optimization"
initial_learning_rate = "initial_learning_rate"
initial_learning_rate_rotation_deviation = "initial_learning_rate_rotation_deviation"
initial_learning_rate_initial_angles = "initial_learning_rate_initial_angles"
initial_learning_rate_initial_stroke_length = (
    "initial_learning_rate_initial_stroke_length"
)
tolerance = "tolerance"
max_epoch = "max_epoch"
batch_size = "batch_size"
log_step = "log_step"
early_stopping_delta = "early_stopping_delta"
early_stopping_patience = "early_stopping_patience"
early_stopping_window = "early_stopping_window"
scheduler = "scheduler"
scheduler_type = "scheduler_type"
exponential = "exponential"
cyclic = "cyclic"
reduce_on_plateau = "reduce_on_plateau"
gamma = "gamma"
lr_min = "lr_min"
lr_max = "lr_max"
step_size_up = "step_size_up"
reduce_factor = "reduce_factor"
patience = "patience"
threshold = "threshold"
cooldown = "cooldown"
constraints = "constraints"
weight_smoothness = "weight_smoothness"
weight_ideal_surface = "weight_ideal_surface"
rho_flux_integral = "rho_flux_integral"
rho_intercept = "rho_intercept"
rho_local_flux = "rho_local_flux"
energy_tolerance = "energy_tolerance"
max_flux_density = "max_flux_density"

# --- distributed setup keys ----------------------------------------------------
device = "device"
is_distributed = "is_distributed"
is_nested = "is_nested"
rank = "rank"
world_size = "world_size"
process_subgroup = "process_subgroup"
groups_to_ranks_mapping = "groups_to_ranks_mapping"
heliostat_group_rank = "heliostat_group_rank"
heliostat_group_world_size = "heliostat_group_world_size"
ranks_to_groups_mapping = "ranks_to_groups_mapping"
