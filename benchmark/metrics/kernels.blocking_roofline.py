"""``kernels.blocking_roofline``: the share of the soft blocking sigma pair's roofline that its kernels
reach in the traced stretch, in %.

The work is what the job needed in the stretch (``run.trace.work["sigma"]``: each needed
forward or backward launch with its chunk's heliostats, rays, candidate slots, kept slots
and kept pairs, counted on the benchmark's reference rays, whatever implements the pair);
the bound of each is :func:`benchmark.blocking_work.sigma_bound_ms`; the time is the device
time of the kernels named in :data:`KERNELS`. The kernels' events must match the program's
launch counter over the stretch (:data:`COUNTERS`, which the job lists among its
``LAUNCH_COUNTERS``), or the run fails. None where the stretch ran no sigma kernel."""

from benchmark.blocking_work import sigma_bound_ms

KERNELS = ("sigma_forward_kernel", "sigma_backward_kernel")
COUNTERS = "artist_tpu_torch.kernels.blocking"


def read(run) -> float | None:
    trace = run.trace
    if trace is None:
        return None
    matched = [(start, end) for name, start, end, kind in trace.device
               if kind == "kernel" and any(kernel in name for kernel in KERNELS)]
    counted = trace.counters.get(COUNTERS, {})
    launches = counted.get("blocking_sigma_forward", 0) + counted.get("blocking_sigma_backward", 0)
    if len(matched) != launches:
        raise RuntimeError(f"{len(matched)} sigma kernel events in the trace against {launches} launches counted")
    if not matched:
        return None
    needed = trace.work.get("sigma", [])
    if len(needed) != launches:
        raise RuntimeError(f"{launches} sigma launches counted against {len(needed)} that the job needed")
    seconds = sum(end - start for start, end in matched)
    bound = sum(sigma_bound_ms(kind, work) for kind, work in needed) * 1e-3
    return 100.0 * bound / seconds
