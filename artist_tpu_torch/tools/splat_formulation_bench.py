"""Head-to-head splat formulations on one NVIDIA GPU, at the flagship shape.

    python3 -m artist_tpu_torch.tools.splat_formulation_bench

The port of ``tools/splat_formulation_bench.py``. At the flagship shape (100
heliostats, 32 rays on each of 50 x 50 x 4 surface points = 32 M rays,
256 x 256 bitmaps, rays ordered point-major over spatial point tiles, from
the same numpy generator and seed as the JAX tool, so both see the same
coordinates) it measures, each kernel with CUDA events over repeated
launches after a warm-up:

1. the full splat (``csrc/splat.cu``): forward, and forward + backward;
2. the dynamic row window of 96 rows (``csrc/splat_window.cu``): forward,
   and forward + backward, and the share of ray blocks that fit;
3. the 2-D window forward (96 x 128 windows, the same source), with its
   largest error relative to the peak against the full splat's plain version
   and its fit fraction;
4. the per-ray accumulate into a whole map held on chip, one band of rows
   in each thread block's shared memory (the kernel of 1's forward, launched
   as ``splat_band_forward``), at the full ray count, with its error as in 3;
5. ``index_add_`` of the same taps as the full splat, one PyTorch call: the
   yardstick of the forward;
6. ``torch.sort`` of 32 M int32 pixel keys: the entry cost of any
   sort-and-segment formulation.

It prints the card's name and power limit and then one JSON line of these
numbers. It needs a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from artist_tpu_torch.kernels.build import build_all
from artist_tpu_torch.kernels.splat import (
    splat_backward_cuda,
    splat_forward_cuda,
    splat_forward_plain,
)
from artist_tpu_torch.kernels.splat_scatter import splat_band_forward_cuda
from artist_tpu_torch.kernels.splat_window import (
    RAY_BLOCK,
    splat_dynamic_window_backward_cuda,
    splat_dynamic_window_forward_cuda,
    window_2d_forward,
)
from artist_tpu_torch.raytracing.splatting import point_tile_order

HELIOSTATS = 100
RAYS = 32
POINTS = 50  # per facet side, x 4 facets
RESOLUTION = (256, 256)  # (width_e, height_u)
WINDOW = 96
ITERATIONS = 10
WARMUP = 2


def flagship_rays(
    heliostats: int = HELIOSTATS, rays: int = RAYS, points: int = POINTS, device="cuda"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX tool's synthetic rays (``_flagship_rays``), ``[heliostats, rays * P]`` each.

    Per-heliostat spots spanning ~185 px, per-point spot centres a smooth
    field over the mirror (facets tile a 2 x 2 grid), per-ray jitter of 6 px
    standard deviation, random weights in [0, 1); rays point-major over the
    surface points in tile order (tiles of 10), so a 1024-ray block covers 32
    consecutive points x 32 rays.
    """
    rng = np.random.default_rng(0)
    count = points * points * 4
    order = np.asarray(point_tile_order(points, points, 4, 10))
    facet = order // (points * points)
    row = (order % (points * points)) // points
    col = order % points
    pu = ((facet // 2) * points + row) / (2 * points)
    pv = ((facet % 2) * points + col) / (2 * points)
    center_u = 35 + 185 * pu
    center_e = 35 + 185 * pv
    u = center_u[None, None, :] + 6.0 * rng.standard_normal((heliostats, rays, count))
    e = center_e[None, None, :] + 6.0 * rng.standard_normal((heliostats, rays, count))
    w = rng.random((heliostats, rays, count)).astype(np.float32)

    def point_major(x: np.ndarray) -> torch.Tensor:
        flat = np.swapaxes(x, 1, 2).reshape(heliostats, rays * count).astype(np.float32)
        return torch.tensor(flat, device=device)

    return point_major(e), point_major(u), point_major(w)


def device_ms(fn, iterations: int = ITERATIONS, warmup: int = WARMUP) -> float:
    """Mean device time of ``fn`` over ``iterations`` back-to-back calls, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _taps(e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int):
    """The valid rays' four taps: flat map ids and deposits, as the full splat adds them."""
    lower_e, lower_u = torch.floor(e), torch.floor(u)
    valid = (lower_e >= 0) & (lower_e <= width - 2) & (lower_u >= 0) & (lower_u <= height - 2)
    fe, fu = e - lower_e, u - lower_u
    base = (lower_u * width + lower_e).long() + torch.arange(e.shape[0], device=e.device)[:, None] * (height * width)
    base, fe, fu, w = base[valid], fe[valid], fu[valid], w[valid]
    ids = torch.cat([base, base + 1, base + width, base + width + 1])
    values = torch.cat([w * (1 - fu) * (1 - fe), w * (1 - fu) * fe, w * fu * (1 - fe), w * fu * fe])
    return ids, values


def run(device="cuda") -> dict:
    """Measure every formulation on ``device`` and return the numbers (see the module note)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the splat-formulation tool measures a CUDA device, and none is available")
    build_all()
    width, height = RESOLUTION
    e, u, w = flagship_rays(device=device)
    num, rays_per_map = e.shape
    g = torch.rand((num, height, width), device=device, generator=torch.Generator(device=device).manual_seed(1))
    result = {
        "card": card(),
        "device": torch.cuda.get_device_name(device),
        "total_rays": num * rays_per_map,
        "resolution": list(RESOLUTION),
        "iterations": ITERATIONS,
    }

    # 1. The full splat.
    result["full_forward_ms"] = device_ms(lambda: splat_forward_cuda(e, u, w, height, width))
    result["full_forward_backward_ms"] = device_ms(
        lambda: (splat_forward_cuda(e, u, w, height, width), splat_backward_cuda(e, u, w, g, height, width))
    )

    # 2. The dynamic row window.
    _, counts = splat_dynamic_window_forward_cuda(e, u, w, height, width, WINDOW)
    blocks = num * -(-rays_per_map // RAY_BLOCK)
    result["dynamic_window_fit_fraction"] = int(counts.sum()) / blocks
    result["dynamic_window_forward_ms"] = device_ms(
        lambda: splat_dynamic_window_forward_cuda(e, u, w, height, width, WINDOW)
    )
    result["dynamic_window_forward_backward_ms"] = device_ms(
        lambda: (
            splat_dynamic_window_forward_cuda(e, u, w, height, width, WINDOW),
            splat_dynamic_window_backward_cuda(e, u, w, g, height, width, WINDOW),
        )
    )

    # 3. The 2-D window forward, held against the full splat's plain version.
    reference = splat_forward_plain(e, u, w, height, width)
    peak = float(reference.max())
    got, fraction = window_2d_forward(e, u, w, RESOLUTION)
    result["window_2d_max_rel_err"] = float((got - reference).abs().max()) / peak
    result["window_2d_fit_fraction"] = float(fraction)
    result["window_2d_forward_ms"] = device_ms(lambda: window_2d_forward(e, u, w, RESOLUTION))

    # 4. The per-ray accumulate in shared memory, band by band, at the full ray count.
    got = splat_band_forward_cuda(e, u, w, height, width)
    result["band_accumulate_max_rel_err"] = float((got - reference).abs().max()) / peak
    result["band_accumulate_forward_ms"] = device_ms(lambda: splat_band_forward_cuda(e, u, w, height, width))
    del got, reference

    # 5. The yardstick: one index_add_ of the same taps.
    ids, values = _taps(e, u, w, height, width)
    out = torch.zeros(num * height * width, device=device)
    result["index_add_forward_ms"] = device_ms(lambda: out.index_add_(0, ids, values))
    del ids, values, out

    # 6. The sort of a sort-and-segment formulation.
    keys = torch.tensor(
        np.random.default_rng(1).integers(0, width * height, num * rays_per_map), dtype=torch.int32, device=device
    )
    result["sort_32m_keys_ms"] = device_ms(lambda: torch.sort(keys))
    return result


def main() -> None:
    result = run()
    print(result["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
