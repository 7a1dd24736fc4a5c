"""A deployment's heliostat field as plain arrays, from the ``field`` block of its configuration file.

Both sides start from these numbers: the program builds its scenario from them,
the reference its own tensors (:func:`reference_field`). Nothing here is derived
by the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FACET_SIGNS = ((-1, 1), (1, 1), (-1, -1), (1, -1))  # (e, n) of the four facets


def field_arrays(field: dict) -> dict:
    """Positions, facets, planar control points, actuators, receiver and site of ``field``, as numpy arrays."""
    count = int(field["heliostats"])
    layout = field["layout"]
    columns = max(1, math.ceil(math.sqrt(count)))
    index = np.arange(count)
    positions = np.stack([
        (index % columns - (columns - 1) / 2) * layout["spacing_e"],
        (index // columns) * layout["spacing_n"] + layout["first_row_n"],
        np.full(count, layout["height"]),
        np.ones(count),
    ], axis=1).astype(np.float32)

    facets = field["facets"]
    canting = np.zeros((len(FACET_SIGNS), 2, 4), np.float32)
    translations = np.zeros((len(FACET_SIGNS), 4), np.float32)
    for k, (sign_e, sign_n) in enumerate(FACET_SIGNS):
        canting[k, 0] = [facets["half_e"], 0.0, -sign_e * facets["cant_u_e"], 0.0]
        canting[k, 1] = [0.0, facets["half_n"], -sign_n * facets["cant_u_n"], 0.0]
        translations[k] = [sign_e * facets["translation_e"], sign_n * facets["translation_n"],
                           facets["translation_u"], 0.0]
    # Flat control grids spanning each facet: e along the first axis, n along the second.
    count_u, count_v = field["control_points"]
    half = np.linalg.norm(canting, axis=-1)  # [F, 2]
    lin_u = np.linspace(0.0, 1.0, count_u, dtype=np.float32)
    lin_v = np.linspace(0.0, 1.0, count_v, dtype=np.float32)
    control_points = np.zeros((len(FACET_SIGNS), count_u, count_v, 3), np.float32)
    control_points[..., 0] = (-half[:, 0, None] + 2 * half[:, 0, None] * lin_u)[:, :, None]
    control_points[..., 1] = (-half[:, 1, None] + 2 * half[:, 1, None] * lin_v)[:, None, :]

    actuators = field["actuators"]
    static = np.zeros((7, 2), np.float32)
    static[1] = actuators["clockwise"]
    static[2] = actuators["min"]
    static[3] = actuators["max"]
    static[4] = actuators["increment"]
    static[5] = actuators["offset"]
    static[6] = actuators["pivot_radius"]
    optimizable = np.array([actuators["initial_angle"], actuators["initial_stroke"]], np.float32)

    def each(a: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.broadcast_to(a, (count,) + a.shape))

    receiver = field["receiver"]
    return dict(
        positions=positions,
        canting=each(canting),
        translations=each(translations),
        control_points=each(control_points),
        static=each(static),
        optimizable=each(optimizable),
        receiver_center=np.array(receiver["center"] + [1.0], np.float32),
        receiver_normal=np.array(receiver["normal"] + [0.0], np.float32),
        receiver_size=np.array(receiver["size"], np.float32),
        surface_points=tuple(field["surface_points"]),
        resolution=tuple(field["bitmap"]),
        rays=int(field["rays"]),
        covariance=float(field["sun_covariance"]),
        degree=int(field["degree"]),
        site={key: float(value) for key, value in field["site"].items()},
    )


def reference_field(arrays: dict, device) -> dict:
    """The field's arrays as the reference reads them: tensors on ``device``."""
    def tensor(name):
        return torch.as_tensor(arrays[name], device=device)

    center = tensor("receiver_center")
    return dict(
        positions=tensor("positions"),
        canting=tensor("canting"),
        translations=tensor("translations"),
        control_points=tensor("control_points"),
        static=tensor("static"),
        optimizable=tensor("optimizable"),
        receiver=dict(center=center, normal=tensor("receiver_normal"), size=tensor("receiver_size"),
                      aim=center[None, :]),
        surface_points=arrays["surface_points"],
        resolution=arrays["resolution"],
        rays=arrays["rays"],
        covariance=arrays["covariance"],
        degree=arrays["degree"],
    )
