"""STRAL binary deflectometry reader.

Counterpart of ``artist_tpu/io/stral.py``: host numpy, each facet's point
block decoded by one ``np.frombuffer`` reshape.

Binary layout:
- surface header: ``=5f2I2f`` - 5 floats, (n_x, n_y) facet grid counts,
  2 floats.
- per facet: header ``=i9fI`` - int, translation (3f), canting_e (3f),
  canting_n (3f), number_of_points (I); then ``number_of_points`` records of
  ``=7f`` - point (3f), normal (3f), 1 float (unused).
"""

from __future__ import annotations

import logging
import pathlib
import struct

import numpy as np

log = logging.getLogger("artist_tpu_torch.io")

_SURFACE_HEADER = struct.Struct("=5f2I2f")
_FACET_HEADER = struct.Struct("=i9fI")
_POINT_RECORD_FLOATS = 7


def extract_stral_deflectometry_data(
    stral_file_path: pathlib.Path | str,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray], list[np.ndarray]]:
    """Extract facet translations, canting vectors, and point/normal clouds.

    Returns
    -------
    tuple
        facet_translations ``[F, 4]`` (direction convention, w=0),
        canting ``[F, 2, 4]``, list of per-facet points ``[N_f, 3]``,
        list of per-facet normals ``[N_f, 3]`` (all float32 numpy).
    """
    log.info("Reading STRAL file located at: %s.", stral_file_path)
    with open(stral_file_path, "rb") as file:
        header = _SURFACE_HEADER.unpack_from(file.read(_SURFACE_HEADER.size))
        n_x, n_y = header[5], header[6]
        number_of_facets = n_x * n_y

        facet_translations = np.zeros((number_of_facets, 4), dtype=np.float32)
        canting = np.zeros((number_of_facets, 2, 4), dtype=np.float32)
        points_per_facet: list[np.ndarray] = []
        normals_per_facet: list[np.ndarray] = []

        for facet in range(number_of_facets):
            facet_header = _FACET_HEADER.unpack_from(file.read(_FACET_HEADER.size))
            facet_translations[facet, :3] = facet_header[1:4]
            canting[facet, 0, :3] = facet_header[4:7]
            canting[facet, 1, :3] = facet_header[7:10]
            number_of_points = facet_header[10]

            raw = np.frombuffer(
                file.read(4 * _POINT_RECORD_FLOATS * number_of_points),
                dtype=np.float32,
            ).reshape(number_of_points, _POINT_RECORD_FLOATS)
            points_per_facet.append(raw[:, 0:3].copy())
            normals_per_facet.append(raw[:, 3:6].copy())

    log.info("Loading STRAL data complete.")
    return facet_translations, canting, points_per_facet, normals_per_facet
