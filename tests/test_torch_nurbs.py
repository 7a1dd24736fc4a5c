"""The port's NURBS evaluation against the JAX package's.

Same numpy control points and evaluation grids through both. Tolerance: the
same fp32 recurrence and one-hot contractions (JAX at ``precision=HIGHEST``),
summed in different orders: ``rtol = 1e-5, atol = 2e-6`` on metre-scale
points and unit normals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.nurbs import surfaces as jax_surfaces
from artist_tpu.nurbs import utils as jax_utils
from artist_tpu_torch.nurbs import surfaces, utils

TOL = dict(rtol=1e-5, atol=2e-6)


def _control_points(rng, num_s=2, num_f=4, cu=7, cv=6):
    cp = np.zeros((num_s, num_f, cu, cv, 3), np.float32)
    cp[..., 0] = np.linspace(-0.8, 0.8, cu, dtype=np.float32)[:, None]
    cp[..., 1] = np.linspace(-0.6, 0.6, cv, dtype=np.float32)[None, :]
    cp[..., 2] = 0.02 * rng.randn(num_s, num_f, cu, cv)
    return cp


def _canting(num_s=2):
    canting = np.zeros((num_s, 4, 2, 4), np.float32)
    translations = np.zeros((num_s, 4, 4), np.float32)
    for i, (se, sn) in enumerate([(-1, 1), (1, 1), (-1, -1), (1, -1)]):
        canting[:, i, 0] = [0.8025, 0.0, -se * 4.98e-3, 0.0]
        canting[:, i, 1] = [0.0, 0.6375, -sn * 3.15e-3, 0.0]
        translations[:, i] = [se * 0.8075, sn * 0.6425, 0.0402, 0.0]
    return canting, translations


def test_evaluation_grid():
    ours = utils.create_nurbs_evaluation_grid((5, 3), device="cpu").numpy()
    theirs = np.asarray(jax_utils.create_nurbs_evaluation_grid((5, 3)))
    # The two linspaces round their interior steps differently: one fp32 ulp.
    np.testing.assert_allclose(ours, theirs, rtol=2.4e-7, atol=0)


def test_planar_control_points():
    canting, _ = _canting()
    ours = utils.create_planar_nurbs_control_points((7, 6), torch.tensor(canting)).numpy()
    theirs = np.asarray(jax_utils.create_planar_nurbs_control_points((7, 6), jnp.asarray(canting)))
    np.testing.assert_allclose(ours, theirs, **TOL)


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("canted", [False, True], ids=["flat", "canted"])
def test_shared_grid_evaluation(degree, canted):
    rng = np.random.RandomState(degree)
    cp = _control_points(rng)
    grid = np.asarray(jax_utils.create_nurbs_evaluation_grid((6, 5)))
    canting, translations = _canting() if canted else (None, None)

    def jnp_or_none(x):
        return None if x is None else jnp.asarray(x)

    def pt_or_none(x):
        return None if x is None else torch.tensor(x)

    theirs = jax_surfaces.evaluate_nurbs_surfaces(
        jnp.asarray(cp), (degree, degree), jnp.asarray(grid),
        canting=jnp_or_none(canting), facet_translations=jnp_or_none(translations),
    )
    ours = surfaces.evaluate_nurbs_surfaces(
        torch.tensor(cp), (degree, degree), torch.tensor(grid),
        canting=pt_or_none(canting), facet_translations=pt_or_none(translations),
    )
    for mine, other in zip(ours, theirs):
        assert mine.shape == (2, 4, 30, 4)
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), **TOL)


def test_per_surface_grid_evaluation():
    rng = np.random.RandomState(7)
    cp = _control_points(rng, num_s=2, num_f=3)
    grid = rng.uniform(1e-3, 1 - 1e-3, size=(2, 3, 11, 2)).astype(np.float32)
    canting, translations = _canting()
    canting, translations = canting[:, :3], translations[:, :3]
    theirs = jax_surfaces.evaluate_nurbs_surfaces(
        jnp.asarray(cp), (3, 3), jnp.asarray(grid),
        canting=jnp.asarray(canting), facet_translations=jnp.asarray(translations),
    )
    ours = surfaces.evaluate_nurbs_surfaces(
        torch.tensor(cp), (3, 3), torch.tensor(grid),
        canting=torch.tensor(canting), facet_translations=torch.tensor(translations),
    )
    for mine, other in zip(ours, theirs):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), **TOL)


def test_spans_and_basis_functions():
    t = np.random.RandomState(8).uniform(0, 1 - 1e-6, size=50).astype(np.float32)
    spans = surfaces.find_spans_uniform(torch.tensor(t), 9, 3)
    np.testing.assert_array_equal(
        spans.numpy(), np.asarray(jax_surfaces.find_spans_uniform(jnp.asarray(t), 9, 3))
    )
    ours = surfaces.basis_functions_and_derivatives(torch.tensor(t), spans, 9, 3, 2)
    theirs = jax_surfaces.basis_functions_and_derivatives(
        jnp.asarray(t), jnp.asarray(spans.numpy(), jnp.int32), 9, 3, 2
    )
    for row_ours, row_theirs in zip(ours, theirs):
        for mine, other in zip(row_ours, row_theirs):
            np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=1e-5, atol=1e-4)


def test_non_uniform_knots_are_refused():
    uniform = np.array([0, 0, 0, 0, 0.25, 0.5, 0.75, 1, 1, 1, 1], np.float64)
    surfaces.validate_uniform_knot_vectors(uniform, 3)
    skewed = uniform.copy()
    skewed[4] = 0.1
    with pytest.raises(ValueError, match="Non-uniform"):
        surfaces.validate_uniform_knot_vectors(skewed, 3)
