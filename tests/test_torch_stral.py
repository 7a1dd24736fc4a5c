"""The port's STRAL reader against the JAX package's, and the geometry helper it feeds.

STRAL binaries are written in the test from a numpy seed with
``chip_smoke.write_stral`` (the layout ``io/stral.py`` documents: a surface
header, then per facet a header and its point records). Both packages must
parse them bit for bit equal. ``rotation_angle_and_axis`` (host float64 in
both) must agree bit for bit too, on its parallel and antiparallel edge cases.
"""

import numpy as np
import pytest

import chip_smoke
from artist_tpu.geometry.rotations import rotation_angle_and_axis as jax_rotation_angle_and_axis
from artist_tpu.io.stral import extract_stral_deflectometry_data as jax_extract
from artist_tpu_torch.geometry.rotations import rotation_angle_and_axis
from artist_tpu_torch.io.stral import extract_stral_deflectometry_data


def _write(path, counts, seed):
    rng = np.random.RandomState(seed)
    translations, canting = chip_smoke.ingress_facets()
    translations[:, :3] += rng.normal(0.0, 1e-3, (4, 3)).astype(np.float32)
    points = [rng.uniform(-0.8, 0.8, (count, 3)) for count in counts]
    normals = [rng.normal(size=(count, 3)) for count in counts]
    chip_smoke.write_stral(path, translations, canting, points, normals)
    return translations, canting, points, normals


@pytest.mark.parametrize(
    "counts", [(2000, 2500, 3000, 3500), (100, 100, 100, 100), (1, 0, 7, 5)], ids=["unequal", "equal", "tiny"]
)
def test_stral_parsers_agree_bit_for_bit(tmp_path, counts):
    path = tmp_path / "cloud.binp"
    translations, canting, points, normals = _write(path, counts, seed=sum(counts))
    ours = extract_stral_deflectometry_data(path)
    theirs = jax_extract(path)
    for mine, other in zip(ours[:2], theirs[:2]):
        assert mine.dtype == other.dtype == np.float32
        np.testing.assert_array_equal(mine, other)
    for mine, other in zip(ours[2] + ours[3], theirs[2] + theirs[3]):
        assert mine.dtype == other.dtype == np.float32 and mine.shape == other.shape
        np.testing.assert_array_equal(mine, other)
    # And what was written: direction convention (w = 0), float32 records.
    np.testing.assert_array_equal(ours[0][:, :3], translations[:, :3])
    np.testing.assert_array_equal(ours[0][:, 3], 0.0)
    np.testing.assert_array_equal(ours[1][..., :3], canting[..., :3])
    for facet, count in enumerate(counts):
        np.testing.assert_array_equal(ours[2][facet], points[facet].astype(np.float32))
        np.testing.assert_array_equal(ours[3][facet], normals[facet].astype(np.float32))
        assert ours[2][facet].shape == (count, 3)


def test_phase_15_clouds_lie_on_their_surface(tmp_path):
    """chip_smoke's dented paraboloids: unit normals, the analytic heights, as read back."""
    dents = chip_smoke.ingress_dents(3)
    path = tmp_path / "AA39.binp"
    chip_smoke.write_ingress_stral(path, 0, 500, dents[0])
    _, _, points, normals = extract_stral_deflectometry_data(path)
    for facet, (p, n) in enumerate(zip(points, normals)):
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
        assert (n[:, 2] > 0.99).all()
        surface, analytic = chip_smoke.facet_local_surface(p[:, 0].astype(np.float64), p[:, 1].astype(np.float64), facet, dents[0])
        np.testing.assert_allclose(p[:, 2], surface[:, 2], atol=1e-7)
        np.testing.assert_allclose(n, analytic, atol=1e-7)


ROTATION_CASES = {
    "generic": ([0.3, -0.4, 0.5, 0.0], [0.1, 0.9, -0.2, 0.0]),
    "south_to_up": ([0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0]),
    "parallel": ([0.0, 2.0, 0.0, 0.0], [0.0, 1.0, 0.0, 1.0]),
    "antiparallel_e_smaller": ([0.1, -1.0, 0.2, 0.0], [-0.1, 1.0, -0.2, 0.0]),
    "antiparallel_n_smaller": ([1.0, 0.1, 0.0, 0.0], [-1.0, -0.1, 0.0, 0.0]),
    "nearly_parallel": ([1.0, 0.0, 0.0, 0.0], [1.0, 1e-8, 0.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(ROTATION_CASES))
def test_rotation_angle_and_axis_matches_jax(case):
    f, t = (np.asarray(x) for x in ROTATION_CASES[case])
    axis, angle = rotation_angle_and_axis(f, t)
    jax_axis, jax_angle = jax_rotation_angle_and_axis(f, t)
    np.testing.assert_array_equal(axis, jax_axis)
    assert angle == jax_angle
    np.testing.assert_allclose(np.linalg.norm(axis), 1.0, rtol=1e-12)
    if case.startswith("antiparallel"):
        assert angle == np.pi and abs(np.dot(axis, f[:3])) < 1e-12
    if case == "south_to_up":
        np.testing.assert_allclose(axis * angle, [-np.pi / 2, 0.0, 0.0], atol=1e-12)
