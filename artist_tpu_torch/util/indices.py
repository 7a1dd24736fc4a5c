"""Named tensor-axis and parameter-row indices.

Mirrors the semantic layout of the reference's packed parameter tensors
(reference: artist/util/indices.py:1-324) so that scenario data round-trips
identically; only the subset actually used by the TPU build is defined.
"""

# ENU components of 4-vectors / rows of 4x4 transforms.
e = 0
n = 1
u = 2
transform_homogeneous = 3

# Rows of the packed non-optimizable actuator parameter tensor [H, 7, 2]
# (linear) or [H, 4, 2] (ideal).
actuator_type = 0
actuator_clockwise_movement = 1
actuator_min_motor_position = 2
actuator_max_motor_position = 3
actuator_increment = 4
actuator_offset = 5
actuator_pivot_radius = 6

# Rows of the optimizable actuator parameter tensor [H, 2, 2] (linear only).
actuator_initial_angle = 0
actuator_initial_stroke_length = 1

# Per-actuator column index.
actuator_one_index = 0
actuator_two_index = 1

# Rows of the kinematics translation deviation tensor [H, 9].
first_joint_translation_e = 0
first_joint_translation_n = 1
first_joint_translation_u = 2
second_joint_translation_e = 3
second_joint_translation_n = 4
second_joint_translation_u = 5
concentrator_translation_e = 6
concentrator_translation_n = 7
concentrator_translation_u = 8

# Rows of the kinematics rotation deviation tensor [H, 4].
first_joint_tilt_n = 0
first_joint_tilt_u = 1
second_joint_tilt_e = 2
second_joint_tilt_n = 3

# Joint-angle components [H, 2].
joint_angles_e = 0
joint_angles_u = 1

# min/max positions as stored in data files.
data_actuator_min_motor_position = 0
data_actuator_max_motor_position = 1

# NURBS parametric directions.
nurbs_u = 0
nurbs_v = 1

# Target-area bookkeeping: planar areas come first in the global index.
planar_target_areas = 0
cylindrical_target_areas = 1
target_dimensions_width = 0
target_dimensions_height = 1

# Bitmap conventions.
unbatched_bitmap_e = 0
unbatched_bitmap_u = 1
bitmap_resolution = 256
bitmap_normalizer = 255.0

# WGS84 coordinate components.
latitude = 0
longitude = 1
altitude = 2

# Dimensions helpers.
heliostat_width = 0
heliostat_height = 1
