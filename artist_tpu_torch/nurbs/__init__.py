from artist_tpu_torch.nurbs.surfaces import evaluate_nurbs_surfaces  # noqa: F401
from artist_tpu_torch.nurbs.utils import (  # noqa: F401
    create_nurbs_evaluation_grid,
    create_planar_nurbs_control_points,
)
