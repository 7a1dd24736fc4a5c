"""``aten.device_ms_per_step``: the device time of every kernel that is not one of the
port's own hand-written kernels (PyTorch's operators: the elementwise chain of the
geometry, the losses and Adam), summed over the traced stretch, over its epochs, in ms."""

PORT_KERNELS = (
    "band_accumulate_kernel", "splat_backward_kernel", "sigma_forward_kernel", "sigma_backward_kernel",
    "blocking_cull_kernel", "sigma_flat_forward_kernel", "sigma_flat_backward_kernel", "sigma_flat_reduce_kernel",
    "lbvh_traverse_kernel",
)


def read(run) -> float | None:
    trace = run.trace
    if trace is None or not trace.epochs:
        return None
    seconds = sum(
        end - start for name, start, end, kind in trace.device
        if kind == "kernel" and not any(kernel in name for kernel in PORT_KERNELS)
    )
    return None if seconds == 0 else 1e3 * seconds / trace.epochs
