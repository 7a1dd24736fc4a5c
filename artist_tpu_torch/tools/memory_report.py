"""Memory of the flagship step at a field configuration, before a plant-scale run runs out of it.

Counterpart of ``tools/memory_report.py``, which reads XLA's compile-time
allocation analysis of the step. PyTorch has no such analysis; this tool runs
one step (the loss of :mod:`artist_tpu_torch.tools.flagship_step` and its
backward) and reports

- the bytes autograd saves for the backward while the loss runs, counted with
  ``torch.autograd.graph.saved_tensors_hooks`` (each storage once; what a
  checkpoint recomputes in the backward is not saved), on any device;
- on the card, ``torch.cuda.max_memory_allocated`` over the step and
  ``torch.cuda.memory_reserved``, beside the card's total memory::

    python -m artist_tpu_torch.tools.memory_report --heliostats 4000 --rays 2 --heliostat-chunk 500 --blocking

so that an operator can pick ``ray_chunk`` and ``heliostat_chunk``.
"""

from __future__ import annotations

import argparse

import torch

from artist_tpu_torch.tools import flagship_step
from artist_tpu_torch.tools.flagship_step import field_inputs, surface_loss

GIB = 1024.0**3


def saved_bytes_of(fn) -> tuple[torch.Tensor, int]:
    """``fn()``'s result and the bytes of the tensors autograd saved for its backward,
    each storage counted once."""
    storages: dict[tuple, int] = {}

    def pack(tensor: torch.Tensor) -> torch.Tensor:
        storage = tensor.untyped_storage()
        storages[(tensor.device, storage.data_ptr())] = storage.nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        result = fn()
    return result, sum(storages.values())


def memory_report(
    device: torch.device | str = "cuda",
    heliostats: int = flagship_step.HELIOSTATS,
    rays: int = flagship_step.RAYS,
    surface_points: int = flagship_step.SURFACE_POINTS[0],
    ray_chunk: int | None = flagship_step.RAY_CHUNK,
    heliostat_chunk: int | None = None,
    blocking: bool = False,
    candidates: int = flagship_step.CANDIDATES,
) -> dict:
    """One step of the configuration: its loss, the saved bytes, the inputs' bytes and,
    on the card, the peak allocated over the step, the reserved and the total bytes
    (None elsewhere)."""
    device = torch.device(device)
    inputs = field_inputs(
        device, heliostats, (surface_points, surface_points), rays, ray_chunk=ray_chunk, blocking=blocking,
        candidates=candidates if blocking else None, heliostat_chunk=heliostat_chunk or None,
    )
    group = inputs.scenario.heliostat_groups[0]
    tensors = [getattr(group, f) for f in ("surface_points", "surface_normals", "nurbs_control_points")]
    input_bytes = sum(t.nbytes for t in tensors + [inputs.distortions_u, inputs.distortions_e, inputs.ground_truth])
    control_points = group.nurbs_control_points.clone().requires_grad_(True)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loss, saved = saved_bytes_of(lambda: surface_loss(control_points, inputs))
    loss.backward()
    if cuda:
        torch.cuda.synchronize(device)
    return dict(
        loss=loss.item(),
        rays=inputs.distortions_u.numel(),
        saved_bytes=saved,
        input_bytes=input_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated(device) if cuda else None,
        memory_reserved=torch.cuda.memory_reserved(device) if cuda else None,
        total_memory=torch.cuda.get_device_properties(device).total_memory if cuda else None,
    )


def describe(report: dict, args) -> list[str]:
    lines = [
        f"{args.heliostats} heliostats x {args.rays} rays x {args.surface_points}^2 x4 points "
        f"({report['rays'] / 1e6:.1f}M rays), blocking={'ON K=' + str(args.candidates) if args.blocking else 'off'}, "
        f"ray_chunk={args.ray_chunk}, heliostat_chunk={args.heliostat_chunk or 'off'}:",
        f"  saved for the backward {report['saved_bytes'] / GIB:.2f} GiB, inputs {report['input_bytes'] / GIB:.2f} GiB",
    ]
    if report["max_memory_allocated"] is not None:
        lines.append(
            f"  peak allocated {report['max_memory_allocated'] / GIB:.2f} GiB, reserved "
            f"{report['memory_reserved'] / GIB:.2f} GiB (card: {report['total_memory'] / GIB:.2f} GiB)"
        )
    return lines


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--heliostats", type=int, default=flagship_step.HELIOSTATS)
    parser.add_argument("--rays", type=int, default=flagship_step.RAYS)
    parser.add_argument("--surface-points", type=int, default=flagship_step.SURFACE_POINTS[0])
    parser.add_argument("--ray-chunk", type=int, default=flagship_step.RAY_CHUNK)
    parser.add_argument("--heliostat-chunk", type=int, default=0)
    parser.add_argument("--blocking", action="store_true")
    parser.add_argument("--candidates", type=int, default=flagship_step.CANDIDATES)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    report = memory_report(
        args.device, args.heliostats, args.rays, args.surface_points, args.ray_chunk, args.heliostat_chunk,
        args.blocking, args.candidates,
    )
    print("\n".join(describe(report, args)))
    return report


if __name__ == "__main__":
    main()
