"""The port of the splat-formulation tool against the JAX tool's Pallas prototypes.

``tools/splat_formulation_bench.py`` is loaded by path. Its 2-D window
forward (``dyn2d_forward``) and its per-ray accumulate (``scatter_forward``)
run in interpret mode on the CPU, with 256-ray blocks (``BLOCK``) on both
sides; the port's counterparts run their plain PyTorch versions on CPU
tensors. Tolerances: the JAX 2-D window builds its factors in bf16 (8
significant bits; the weight is folded into the row factor before the cast),
so each deposit differs from fp32 by at most two bf16 roundings, 2^-7 of its
magnitude, and each pixel by 2^-7 of the sum of its deposits' magnitudes; its
fit fraction comes from the same rules on the same fp32 coordinates and must
be equal. The per-ray accumulate is fp32 in both, summed in other orders:
1e-6 of the peak.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.raytracing.splatting import bilinear_splat as jax_bilinear_splat
from artist_tpu_torch.kernels import splat_scatter, splat_window
from artist_tpu_torch.tools import splat_formulation_bench as tool

REPO = Path(__file__).resolve().parent.parent
BLOCK = 256
RESOLUTION = (256, 256)
SMALL = dict(heliostats=2, rays=8, points=20)
# The H100's shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin).
H100_SHARED_BYTES = 232448

splat_kernels = importlib.import_module("artist_tpu_torch.kernels.splat")


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_splat_formulation_bench", REPO / "tools" / "splat_formulation_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch, jax_tool):
    monkeypatch.setattr(jax_tool, "BLOCK", BLOCK)
    monkeypatch.setattr(splat_window, "RAY_BLOCK", BLOCK)
    monkeypatch.setattr(jax_tool, "HELIOSTATS", SMALL["heliostats"])
    monkeypatch.setattr(jax_tool, "RAYS", SMALL["rays"])
    monkeypatch.setattr(jax_tool, "POINTS", SMALL["points"])


def _small_rays():
    """The tool's flagship rays at a small size (2 heliostats x 25,600 rays, spots
    across the bitmap), a block of rays spread over the whole bitmap, and a few
    out-of-bounds rays."""
    e, u, w = (x.numpy().copy() for x in tool.flagship_rays(**SMALL, device="cpu"))
    rng = np.random.RandomState(0)
    e[:, 512:768] = rng.uniform(0, 255, (2, 256))
    u[:, :7] = -3.0
    e[:, 900:905] = 300.0
    return e, u, w


def _magnitude(e, u, w):
    """Per pixel, the sum of the magnitudes of its deposits."""
    return splat_kernels.splat_forward_plain(*(torch.tensor(x) for x in (e, u, np.abs(w))), *RESOLUTION[::-1]).numpy()


def test_flagship_rays_equal_jax(jax_tool):
    ours = tool.flagship_rays(**SMALL, device="cpu")
    theirs = jax_tool._flagship_rays()
    for mine, other in zip(ours, theirs):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(other))


def test_window_2d_forward_matches_jax(jax_tool):
    e, u, w = _small_rays()
    out, fraction = splat_window.window_2d_forward(*(torch.tensor(x) for x in (e, u, w)), RESOLUTION)
    out_jax, fraction_jax = jax_tool.dyn2d_forward(*(jnp.asarray(x) for x in (e, u, w)), RESOLUTION)
    assert 0 < float(fraction) < 1, "some blocks must fit their 2-D window and some not"
    assert float(fraction) == float(fraction_jax)
    limit = 2.0**-7 * _magnitude(e, u, w) + 1e-6
    assert np.all(np.abs(out.numpy() - np.asarray(out_jax)) <= limit)


def test_window_2d_forward_is_exact():
    """The 2-D window drops nothing: the full splat's plain version, to 1e-6 of the peak."""
    e, u, w = (torch.tensor(x) for x in _small_rays())
    out, _ = splat_window.window_2d_forward(e, u, w, RESOLUTION)
    full = splat_kernels.splat_forward_plain(e, u, w, *RESOLUTION[::-1])
    jax_full = np.asarray(
        jax_bilinear_splat(*(jnp.asarray(x.numpy()) for x in (e, u, w)), RESOLUTION, flip_up_down=False, method="scatter")
    )
    peak = float(full.max())
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=0, atol=1e-6 * peak)
    np.testing.assert_allclose(out.numpy(), jax_full, rtol=0, atol=1e-6 * peak)


def test_window_2d_plain_version_asserts_that_deposits_lie_in_their_window():
    e, u, w = (torch.tensor(x) for x in _small_rays())
    height, width = RESOLUTION[1], RESOLUTION[0]
    ou, oe, fits = splat_window.window_2d_offsets(e, u, height, width)
    args = (e, u, w, height, width, BLOCK, 96, 128)
    splat_window._window_forward_plain(*args, ou, oe, fits)
    moved = fits.bool() & (oe < width - 128)
    assert moved.any()
    with pytest.raises(AssertionError, match="outside its window"):
        splat_window._window_forward_plain(*args, ou, torch.where(moved, oe + 128, oe), fits)


@pytest.mark.parametrize("window", [(90, 128), (96, 100), (96, 384)], ids=["rows_unaligned", "columns_unaligned", "too_wide"])
def test_bad_2d_windows_raise(window):
    e, u, w = (torch.tensor(x) for x in _small_rays())
    with pytest.raises(ValueError, match="multiple of"):
        splat_window.window_2d_forward(e, u, w, RESOLUTION, *window)


def test_band_accumulate_plain_version_matches_jax(jax_tool):
    e, u, w = (x[:1, :768] for x in _small_rays())
    out = splat_scatter.splat_band_forward(*(torch.tensor(x) for x in (e, u, w)), RESOLUTION)
    out_jax = np.asarray(jax_tool.scatter_forward(*(jnp.asarray(x) for x in (e, u, w)), RESOLUTION))
    assert out.sum() > 0
    np.testing.assert_allclose(out.numpy(), out_jax, rtol=0, atol=1e-6 * float(out_jax.max()))


@pytest.mark.parametrize(
    "height, width, band_rows",
    [
        (256, 256, 128),  # the flagship and tool maps: 2 bands of 128 KB
        (64, 64, 64),  # the whole map in one band
        (1, 256, 1),
        (4096, 256, 216),  # taller than 18 blocks' shared memory: 19 bands
        (255, 256, 128),  # an odd height: bands of 128 and 127 rows
        (256, 40_000, 1),  # one row is more than half a block's shared memory: one row a band
        (256, 60_000, None),  # one row does not fit a block
    ],
    ids=["flagship", "small", "one_row", "tall", "odd_height", "wide", "too_wide"],
)
def test_band_layout(height, width, band_rows):
    if band_rows is None:
        with pytest.raises(ValueError, match="does not fit"):
            splat_kernels.band_layout(height, width, H100_SHARED_BYTES)
        return
    assert splat_kernels.band_layout(height, width, H100_SHARED_BYTES) == band_rows
    bands = -(-height // band_rows)
    # Every row has exactly one band, none of them empty; each band fits a block's shared
    # memory with its padding; one band fewer would not fit.
    assert (bands - 1) * band_rows < height <= bands * band_rows
    assert 4 * band_rows * width + splat_kernels.BAND_PAD_BYTES <= H100_SHARED_BYTES
    fewer = -(-height // (bands - 1)) if bands > 1 else None
    assert fewer is None or 4 * fewer * width + splat_kernels.BAND_PAD_BYTES > H100_SHARED_BYTES


def test_plain_paths_launch_no_kernel():
    before = {**splat_window.LAUNCHES, **splat_scatter.LAUNCHES}
    e, u, w = (torch.tensor(x) for x in _small_rays())
    splat_window.window_2d_forward(e, u, w, RESOLUTION)
    splat_scatter.splat_band_forward(e, u, w, RESOLUTION)
    assert {**splat_window.LAUNCHES, **splat_scatter.LAUNCHES} == before


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_tool_raises_without_a_card(device, monkeypatch):
    """The tool measures a card and never runs on the CPU (here on any machine)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.run(device)
