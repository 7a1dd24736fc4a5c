"""``RenderConfig``'s fields from the JAX package: ``primitive_chunk``,
``remat_chunks``, ``splat_method`` and ``blocking_method``.

The port computes the Pallas routes' semantics whatever ``splat_method`` and
``blocking_method`` say, and its blocking mask is the same with or without
``primitive_chunk``: the flux must be equal, exactly. ``remat_chunks=False``
stores each ray chunk's residuals instead of recomputing them: the same
arithmetic, so flux, loss and gradient to 1e-6 (the backward's sums taken in
the same order; the tolerance allows a last-bit difference), with one splat
forward fewer for each chunk (counted on the plain version the CPU runs).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu_torch.raytracing.render import RenderConfig
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario

HELIOSTATS = 9  # three rows 3 m apart, which block each other with blocking on
POINTS = (5, 5)
RAYS = 8
BITMAP = (32, 32)
RAY_CHUNK = 2
splat = importlib.import_module("artist_tpu_torch.kernels.splat")


def _inputs(blocking: bool = False, **config):
    scenario = make_synthetic_scenario(
        number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS, number_of_rays=RAYS,
        device="cpu",
    )
    if blocking:
        group = scenario.heliostat_groups[0]
        positions = torch.tensor(chip_smoke.row_positions(HELIOSTATS, chip_smoke.DENSE_ROW_SPACING))
        scenario.heliostat_groups[0] = group.replace(positions=positions)
    rng = np.random.RandomState(chip_smoke.SEED)
    du, de = (torch.tensor(x) for x in rng.normal(0.0, 1e-2, (2, HELIOSTATS, RAYS, 4 * POINTS[0] * POINTS[1])).astype(np.float32))
    inputs = chip_smoke.step_inputs(scenario, du, de, POINTS, BITMAP, RAY_CHUNK, blocking)
    inputs.config = dataclasses.replace(inputs.config, **config)
    return inputs


def test_render_config_takes_the_jax_packages_fields():
    """``RenderConfig`` as ``bench.py:_build_step`` builds it, and the blocking trace
    with those fields equal to the one without."""
    config = RenderConfig(
        bitmap_resolution=BITMAP,
        ray_chunk=RAY_CHUNK,
        blocking_active=True,
        primitive_chunk=2,
        blocking_candidates=16,
        splat_window=None,
        splat_block_window=None,
        splat_point_layout=None,
        splat_method="pallas_fp32",
        blocking_method="xla",
        remat_chunks=True,
    )
    assert config.primitive_chunk == 2 and config.splat_method == "pallas_fp32"
    inputs = _inputs(blocking=True)
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points
    with torch.no_grad():
        plain = chip_smoke.render(control_points, inputs)
        inputs.config = config
        chosen = chip_smoke.render(control_points, inputs)
    assert float(plain[3].min()) < 1  # something blocks on the 3 m rows
    for mine, other in zip(chosen, plain):
        torch.testing.assert_close(mine, other, rtol=0, atol=0)


@pytest.mark.parametrize("blocking", [False, True], ids=["plain", "blocking"])
def test_remat_chunks_false_stores_instead_of_recomputing(blocking, monkeypatch):
    calls = []
    forward = splat.splat_forward_plain
    monkeypatch.setattr(splat, "splat_forward_plain", lambda *args: calls.append(1) or forward(*args))
    results = {}
    for remat in (True, False):
        inputs = _inputs(blocking, remat_chunks=remat)
        control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
        calls.clear()
        flux = chip_smoke.render(control_points, inputs)[0]
        loss = torch.sum(flux * torch.linspace(0.5, 1.5, flux.numel()).reshape(flux.shape))
        loss.backward()
        results[remat] = (flux.detach(), loss.detach(), control_points.grad, len(calls))
    chunks = RAYS // RAY_CHUNK
    assert results[True][3] == 2 * chunks and results[False][3] == chunks
    for mine, other in zip(results[False][:3], results[True][:3]):
        torch.testing.assert_close(mine, other, rtol=1e-6, atol=1e-6 * float(other.abs().max()))
    assert float(results[True][2].abs().max()) > 0
