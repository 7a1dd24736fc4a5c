"""``kernels.splat_roofline``: the share of the bilinear splat's roofline that its kernels reach
in the traced stretch, in %.

The work is what the job needed in the stretch (``run.trace.work["splat"]``: each needed
forward or backward splat with its maps, rays, valid rays and touched pixels,
counted on the benchmark's reference rays, whatever implements the splat); the time
is the device time of the kernels named in :data:`KERNELS`. Each input byte counts
once and each output byte once:

- forward: e and u 8 B a ray and w 4 B a valid ray read, the maps written (4 B a
  pixel); 14 fp32 operations a valid ray (2 fractions, 2 complements, 6 products,
  4 adds);
- backward: e and u 8 B a ray and w 4 B a valid ray read, the three cotangents
  written (12 B a ray), the maps' cotangent read at the touched pixels (4 B each);
  29 operations a valid ray.

The bound is the larger of bytes over the card's bandwidth and operations over its
fp32 rate. The kernels' events must match the program's launch counter over the
stretch (:data:`COUNTERS`, which the job lists among its ``LAUNCH_COUNTERS``), or the run fails."""

from benchmark.roofline import bound_ms

KERNELS = ("band_accumulate_kernel", "splat_backward_kernel")
COUNTERS = "artist_tpu_torch.kernels.splat"
FORWARD_FLOPS_PER_VALID_RAY = 14
BACKWARD_FLOPS_PER_VALID_RAY = 29


def splat_bound_ms(kind: str, work: dict) -> float:
    rays, valid, maps = work["rays"], work["valid"], work["maps"]
    if kind == "forward":
        return bound_ms(8 * rays + 4 * valid + 4 * maps * work["height"] * work["width"],
                        FORWARD_FLOPS_PER_VALID_RAY * valid)[0]
    return bound_ms(8 * rays + 4 * valid + 12 * rays + 4 * work["touched"], BACKWARD_FLOPS_PER_VALID_RAY * valid)[0]


def read(run) -> float | None:
    trace = run.trace
    if trace is None:
        return None
    matched = [(start, end) for name, start, end, kind in trace.device
               if kind == "kernel" and any(kernel in name for kernel in KERNELS)]
    counted = trace.counters.get(COUNTERS, {})
    launches = counted.get("splat_forward", 0) + counted.get("splat_backward", 0)
    if len(matched) != launches:
        raise RuntimeError(f"{len(matched)} splat kernel events in the trace against {launches} launches counted")
    if not matched:
        return None
    seconds = sum(end - start for start, end in matched)
    bound = sum(splat_bound_ms(kind, work) for kind, work in trace.work.get("splat", [])) * 1e-3
    return 100.0 * bound / seconds
