"""The metric arithmetic: interval union, idle share and gaps, p95, host syncs, the splat's work and bound."""

from __future__ import annotations

import importlib.util
import math

import pytest
import torch

from benchmark import roofline
from benchmark import trace as tracing
from benchmark.reference import steps

from conftest import REPO


def reader(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    def __init__(self, trace=None, epoch_seconds=(), window_s=0.0):
        self.trace, self.epoch_seconds, self.window_s = trace, list(epoch_seconds), window_s
        self.setup_s, self.peak_bytes = 12.5, 2_000_000_000


def stretch(**changes) -> tracing.Trace:
    values = dict(
        device=[("k1", 0.0, 1.0, "kernel"), ("k2", 0.5, 2.0, "kernel"), ("Memcpy DtoH (Device -> Pageable)", 4.0, 5.0,
                                                                         "memcpy"),
                ("band_accumulate_kernel<0>", 6.0, 6.5, "kernel")],
        runtime=[("cudaLaunchKernel", 2.0, 2.5, 11), ("cudaMemcpy", 3.9, 5.1, 12), ("cudaStreamSynchronize", 7.0, 7.5, 13),
                 ("cudaMemcpyAsync", 5.5, 5.6, 14)],
        host=[("aten::mul", 1.9, 3.0), ("aten::item", 3.5, 5.2), ("aten::outer", 7.0, 9.5), ("aten::inner", 8.0, 9.0)],
        start=0.0, end=10.0, epochs=2, copies={12: "Memcpy DtoH (Device -> Pageable)", 14: "Memcpy HtoD (Pageable)"},
    )
    values.update(changes)
    return tracing.Trace(**values)


def test_union_merges_overlaps_and_keeps_gaps():
    assert tracing.union([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (2.0, 2.5)]) == [(0.0, 2.5), (3.0, 4.0)]
    assert stretch().busy_s() == pytest.approx(2.0 + 1.0 + 0.5)


def test_idle_share_events_and_syncs():
    run = Run(stretch())
    assert reader("device.idle_share").read(run) == pytest.approx(100.0 * (1 - 3.5 / 10.0))
    assert reader("device.events_per_step").read(run) == 2.0
    # the stream synchronization and the synchronous copy to the host; the asynchronous one is not a wait
    assert reader("optim.host_syncs_per_step").read(run) == 1.0
    assert reader("aten.device_ms_per_step").read(run) == pytest.approx(1e3 * (1.0 + 1.5) / 2)
    assert reader("device.idle_share").read(Run(None)) is None


def test_idle_gaps_are_labelled_by_the_innermost_host_activity():
    gaps = dict(tracing.idle_gaps(stretch()))
    assert gaps["aten::mul"] == pytest.approx(2.0)  # 2.0 to 4.0, middle 3.0: the launch ended at 2.5
    assert gaps["cudaMemcpyAsync"] == pytest.approx(1.0)  # 5.0 to 6.0, middle 5.5: the latest call started
    assert gaps["aten::inner"] == pytest.approx(3.5)  # 6.5 to 10.0, middle 8.25
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.5)
    assert tracing.top_device_ops(stretch())[0] == ["k2", 1.5]


def test_p95_and_step_time():
    epochs = [0.1] * 95 + [1.0] * 5
    run = Run(epoch_seconds=epochs, window_s=sum(epochs))
    assert reader("step_ms").read(run) == pytest.approx(1e3 * sum(epochs) / 100)
    p95 = reader("step_p95_ms")
    assert p95.percentile(list(range(1, 102)), 95.0) == pytest.approx(96.0)
    assert p95.read(run) == pytest.approx(1e3 * (0.1 + (1.0 - 0.1) * 0.05))
    assert reader("peak_mem_gb").read(run) == 2.0
    assert reader("setup_s").read(run) == 12.5


def test_splat_counts_of_known_rays():
    # two maps of 4 x 4 pixels: a ray inside, one on the last column (dropped), one outside, one sharing taps
    e = torch.tensor([[0.5, 3.0, -1.0, 0.75]] * 2)
    u = torch.tensor([[0.5, 1.0, -1.0, 0.25]] * 2)
    w = torch.ones_like(e)

    def rays(parameters, part):
        return e[part], u[part], w[part]

    counts = steps.splat_counts(2, rays, None, 1, (4, 4))
    assert counts == dict(maps=2, rays=8, valid=4, touched=8, width=4, height=4)


def test_splat_bound_and_roofline():
    module = reader("kernels.splat_roofline")
    work = dict(maps=2, rays=1000, valid=500, touched=40, width=4, height=4)
    forward_bytes = 8 * 1000 + 4 * 500 + 4 * 2 * 16
    backward_bytes = 8 * 1000 + 4 * 500 + 12 * 1000 + 4 * 40
    assert module.splat_bound_ms("forward", work) == pytest.approx(forward_bytes / roofline.PEAK_BYTES_PER_S * 1e3)
    assert module.splat_bound_ms("backward", work) == pytest.approx(backward_bytes / roofline.PEAK_BYTES_PER_S * 1e3)
    assert roofline.bound_ms(0.0, 67e12)[1] == "operations"
    counted = {module.COUNTERS: {"splat_forward": 1, "splat_backward": 0}}
    trace = stretch(counters=counted, work={"splat": [("forward", work)]})
    share = module.read(Run(trace))
    assert share == pytest.approx(100.0 * module.splat_bound_ms("forward", work) * 1e-3 / 0.5)
    with pytest.raises(RuntimeError, match="launches"):
        module.read(Run(stretch(counters={module.COUNTERS: {"splat_forward": 2, "splat_backward": 0}})))
    no_splat = stretch(device=[("k1", 0.0, 1.0, "kernel")], counters={})
    assert module.read(Run(no_splat)) is None
    assert math.isfinite(share)
