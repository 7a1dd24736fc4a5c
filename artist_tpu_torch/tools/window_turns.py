"""The splat kernels of the block-window route beside the full splat's, timed in turns.

    python3 artist_tpu_torch/tools/window_turns.py [--repo CHECKOUT] [--rounds 2]

Imports ``chip_smoke`` and ``artist_tpu_torch`` from ``--repo`` (default: the
checkout this file lies in), so that one command can time a parent commit's
kernels and this one's in turns on one card. On the block-window step's
first ray chunk (``chip_smoke.first_chunk_rays``: ``[100, 4, 10000]`` rays
onto ``[100, 256, 256]`` maps) it times

- row 1, the full splat's forward, and row 2, its backward, on the rays as
  the step makes them (``[M, r * P]``);
- row 3, the dynamic-window forward, and row 4, its backward, as the
  checkout's block-window route calls them: on the rays in place with the
  point order where the wrappers take ``point_order``, else (a checkout from
  before the kernels read the rays in place) on a point-major copy of them in
  the point order, as that checkout's render step made it;

and on the formulation tool's 32 M rays row 13, the 2-D window forward, and
row 14, the band accumulate. Each kernel is timed by CUDA events over 20
back-to-back calls and replayed from a CUDA graph (``chip_smoke.event_ms``,
``chip_smoke.graph_ms``), ``--rounds`` times in turns. It also prints the
fitting blocks of rows 3 and 13, and what a warp of the window plan touches
when it reads the chunk's rays through the point order
(``point_tile_order(50, 50, 4, 10)``): the runs of consecutive point indices
and the 128-byte lines of one ray stream that 32 consecutive rays of the
point-major sequence fall on. Prints the card's name and power limit, then
one JSON line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import pathlib
import sys

import numpy as np

LINE_BYTES = 128
WARP = 32


def _distinct_per_warp(values: np.ndarray) -> np.ndarray:
    warps = values[: values.size // WARP * WARP].reshape(-1, WARP)
    return np.array([np.unique(row).size for row in warps])


def plan_reads(order: np.ndarray, rays_per_point: int, points: int, block: int) -> dict:
    """What reading the point-major sequence through ``order`` costs a warp: the runs of
    consecutive point indices in ``order``; the distinct 128-byte lines of a ``[r, P]``
    fp32 stream that each 32 consecutive rays of the sequence fall on; and, the other
    way round, the distinct ray blocks (of ``block`` rays of the sequence) that each 32
    consecutive rays of the stream's own layout belong to."""
    runs = 1 + int(np.count_nonzero(np.diff(order) != 1))
    point, ray = np.divmod(np.arange(rays_per_point * points), rays_per_point)
    lines = _distinct_per_warp((ray * points + order[point]) * 4 // LINE_BYTES)
    position = np.empty_like(order)
    position[order] = np.arange(points)
    ray, point = np.divmod(np.arange(rays_per_point * points), points)
    blocks = _distinct_per_warp((position[point] * rays_per_point + ray) // block)
    return dict(
        points=points,
        runs=runs,
        mean_run=points / runs,
        lines_per_warp_mean=float(lines.mean()),
        lines_per_warp_max=int(lines.max()),
        lines_per_warp_in_place=WARP * 4 // LINE_BYTES,
        blocks_per_warp_in_place_mean=float(blocks.mean()),
        blocks_per_warp_in_place_max=int(blocks.max()),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=pathlib.Path, default=pathlib.Path(__file__).resolve().parents[2])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))

    import torch

    import chip_smoke as c
    from artist_tpu_torch.kernels import splat_scatter, splat_window
    from artist_tpu_torch.kernels.build import build_all
    from artist_tpu_torch.raytracing import render
    from artist_tpu_torch.tools import splat_formulation_bench

    splat_kernels = importlib.import_module("artist_tpu_torch.kernels.splat")
    if not torch.cuda.is_available():
        print("window_turns: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_all()
    width, height = c.BITMAP
    window = c.BLOCK_WINDOW["splat_block_window"]
    inputs = c.flagship_inputs(device, **c.BLOCK_WINDOW)
    chunk = inputs.config.ray_chunk
    e, u, w = c.first_chunk_rays(inputs)
    num, rays_per_map = e.shape
    points = rays_per_map // chunk
    order = render.point_permutation(inputs.config, device)
    g = torch.randn((num, height, width), device=device, generator=torch.Generator(device=device).manual_seed(c.SEED + 1))
    in_place = "point_order" in inspect.signature(splat_window.splat_dynamic_window_forward_cuda).parameters
    if in_place:
        streams = tuple(x.reshape(num, chunk, points) for x in (e, u, w))
        window_kwargs = dict(point_order=order)
    else:
        streams = tuple(
            x.reshape(num, chunk, points).transpose(1, 2)[:, order.long()].reshape(num, -1).contiguous()
            for x in (e, u, w)
        )
        window_kwargs = {}
    tool = splat_formulation_bench.flagship_rays(device=device)

    kernels = {
        "row1_splat_forward": lambda: splat_kernels.splat_forward_cuda(e, u, w, height, width),
        "row2_splat_backward": lambda: splat_kernels.splat_backward_cuda(e, u, w, g, height, width),
        "row3_window_forward": lambda: splat_window.splat_dynamic_window_forward_cuda(
            *streams, height, width, window, **window_kwargs
        ),
        "row4_window_backward": lambda: splat_window.splat_dynamic_window_backward_cuda(
            *streams, g, height, width, window, **window_kwargs
        ),
        "row13_window_2d_forward": lambda: splat_window.splat_window_2d_forward_cuda(*tool, height, width),
        "row14_band_forward": lambda: splat_scatter.splat_band_forward_cuda(*tool, height, width),
    }
    times: dict[str, dict[str, list[float]]] = {name: {"events": [], "graph": []} for name in kernels}
    for _ in range(args.rounds):
        for name, fn in kernels.items():
            times[name]["events"].append(c.event_ms(fn))
            times[name]["graph"].append(c.graph_ms(fn))
    result = dict(
        device=torch.cuda.get_device_name(device),
        repo=str(args.repo),
        in_place=in_place,
        rays=[num, rays_per_map],
        tool_rays=list(tool[0].shape),
        fitting_row3=int(kernels["row3_window_forward"]()[1].sum()),
        blocks_row3=num * -(-rays_per_map // splat_window.RAY_BLOCK),
        fitting_row13=int(kernels["row13_window_2d_forward"]()[1].sum()),
        blocks_row13=tool[0].shape[0] * -(-tool[0].shape[1] // splat_window.RAY_BLOCK),
        plan_reads=plan_reads(order.cpu().numpy().astype(np.int64), chunk, points, splat_window.RAY_BLOCK),
        ms=times,
    )
    print(c.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
