"""The port's spans and its transfer counter, on the CPU.

:func:`artist_tpu_torch.util.logging_utils.span` is a ``record_function`` range while a
profiler records and one shared no-op object otherwise. The reconstruction loops open
``artist.<layer>.<stage>`` spans at their layer boundaries: one ``artist.entry.call`` a
call, one ``artist.entry.preamble`` a group (with ``parse``, ``split`` and ``batches``
inside), one ``artist.optim.epoch`` an epoch, and the ``artist.aten.*`` and
``artist.kernels.*`` spans inside an epoch or a preamble. The batches count the bytes they
copy from the host in ``training.TRANSFERS``.

Each reconstruction here runs once on the synthetic field (3 heliostats, 4 samples each,
4 rays, 32 x 32 maps), under a CPU profiler, with the splat's plain versions counted.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu_torch.optim import training
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.scenario.synthetic import SyntheticCalibrationParser, make_synthetic_scenario
from artist_tpu_torch.util import constants, logging_utils

# The module, not the function of the same name that the package exports.
splat = importlib.import_module("artist_tpu_torch.kernels.splat")

CPU = torch.device("cpu")
MAX_EPOCH = 3  # 4 epochs a call
SIZE = dict(heliostats=3, samples=4, surface_points=(4, 4), rays=4, bitmap=(32, 32))
RUNS = ("alignment", "raytracing", "surface")
LAYER_PREFIXES = ("artist.aten.", "artist.kernels.")


def test_span_without_a_profiler_is_one_shared_object_that_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    def args():
        raise AssertionError("the span's argument formatted with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = logging_utils.span("artist.optim.epoch", args)
    assert first is logging_utils.span("artist.aten.trace") is logging_utils.span("artist.entry.call", "0")
    with first:
        with logging_utils.span("artist.optim.fetch", args):
            pass


def test_span_under_a_profiler_is_a_range_with_its_argument():
    calls = []

    def args():
        calls.append(1)
        return "7"

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
        with logging_utils.span("artist.optim.epoch", args):
            torch.ones(4).sum()
    names = [event.name() for event in profiler.profiler.kineto_results.events()]
    assert names.count("artist.optim.epoch") == 1 and calls == [1]


def _configuration(kind: str) -> dict:
    if kind == "surface":
        return chip_smoke.reconstruction_configuration(MAX_EPOCH)
    return chip_smoke.kinematics_configuration(MAX_EPOCH)


def _reconstructor(kind: str):
    if kind == "surface":
        scenario = make_synthetic_scenario(
            number_of_heliostats=SIZE["heliostats"], number_of_control_points_per_facet=(5, 5),
            number_of_surface_points_per_facet=SIZE["surface_points"], number_of_rays=SIZE["rays"], device=CPU,
        )
        parser = SyntheticCalibrationParser(samples_per_heliostat=SIZE["samples"])
        reconstructor = SurfaceReconstructor(
            scenario, {constants.data_parser: parser, constants.heliostat_data_mapping: []}, _configuration(kind),
            number_of_surface_points=SIZE["surface_points"], bitmap_resolution=SIZE["bitmap"], ray_chunk=2,
        )
        return reconstructor, lambda on_epoch: reconstructor.reconstruct_surfaces(on_epoch=on_epoch)
    known = chip_smoke.known_rotation_deviations(SIZE["heliostats"])
    data = chip_smoke.kinematics_calibration(
        chip_smoke.kinematics_scenario(CPU, SIZE), known, SIZE["samples"], SIZE["bitmap"]
    )
    method = {"alignment": constants.kinematics_reconstruction_alignment,
              "raytracing": constants.kinematics_reconstruction_raytracing}[kind]
    reconstructor = chip_smoke.kinematics_reconstructor(CPU, SIZE, data, method, _configuration(kind))
    return reconstructor, lambda on_epoch: reconstructor.reconstruct_kinematics(on_epoch=on_epoch)


def _counted(monkeypatch, name: str, calls: dict):
    plain = getattr(splat, name)

    def counting(*args, **kwargs):
        calls[name] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(splat, name, counting)


@pytest.fixture(scope="module", params=RUNS)
def traced(request):
    """One call of the reconstruction under a CPU profiler: its ``artist.`` spans as
    (name, start ns, end ns), its epochs, the splat's plain calls, the bytes counted
    and the reconstructor."""
    kind = request.param
    reconstructor, call = _reconstructor(kind)
    epochs: list[int] = []
    calls = {"splat_forward_plain": 0, "splat_backward_plain": 0}
    with pytest.MonkeyPatch.context() as monkeypatch:
        for name in calls:
            _counted(monkeypatch, name, calls)
        training.reset_transfer_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
            call(lambda epoch, loss: epochs.append(epoch))
    spans = [
        (event.name(), event.start_ns(), event.start_ns() + event.duration_ns())
        for event in profiler.profiler.kineto_results.events()
        if event.name().startswith("artist.")
    ]
    return dict(kind=kind, spans=spans, epochs=epochs, calls=calls, reconstructor=reconstructor,
                transfers=dict(training.TRANSFERS))


def _named(traced: dict, name: str) -> list[tuple[str, int, int]]:
    return [span for span in traced["spans"] if span[0] == name]


def _inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_one_call_span_and_one_preamble_a_group(traced):
    (call,) = _named(traced, "artist.entry.call")
    groups = len(traced["reconstructor"].scenario.heliostat_groups)
    preambles = _named(traced, "artist.entry.preamble")
    assert len(preambles) == groups == 1
    assert all(_inside(preamble, call) for preamble in preambles)
    for stage in ("artist.entry.parse", "artist.entry.split", "artist.entry.batches"):
        (inner,) = _named(traced, stage)
        assert _inside(inner, preambles[0]), stage


def test_one_epoch_span_an_epoch(traced):
    epochs = _named(traced, "artist.optim.epoch")
    assert len(traced["epochs"]) == MAX_EPOCH + 1
    assert len(epochs) == len(traced["epochs"]) == len(_named(traced, "artist.optim.fetch"))
    (preamble,) = _named(traced, "artist.entry.preamble")
    assert all(epoch[1] >= preamble[2] for epoch in epochs)
    # A validation where the loop logs (epoch % log_step == 0, epoch max_epoch - 1), inside its epoch.
    log_step = _configuration(traced["kind"])[constants.optimization][constants.log_step]
    validations = _named(traced, "artist.optim.validate")
    assert len(validations) == chip_smoke.validations(traced["epochs"], MAX_EPOCH, log_step, False) > 0
    assert all(any(_inside(validation, epoch) for epoch in epochs) for validation in validations)


def test_layer_spans_lie_inside_an_epoch_or_a_preamble(traced):
    outers = _named(traced, "artist.optim.epoch") + _named(traced, "artist.entry.preamble")
    layered = [span for span in traced["spans"] if span[0].startswith(LAYER_PREFIXES)]
    assert layered
    assert all(any(_inside(span, outer) for outer in outers) for span in layered)
    names = {span[0] for span in layered}
    # Every method traces: the alignment method in its validations.
    assert {"artist.aten.align", "artist.aten.trace", "artist.aten.loss", "artist.aten.backward"} <= names
    if traced["kind"] == "surface":
        assert "artist.aten.nurbs" in names
    for epoch in _named(traced, "artist.optim.epoch"):
        inner = {span[0] for span in traced["spans"] if _inside(span, epoch) and span != epoch}
        assert {"artist.optim.update", "artist.optim.fetch", "artist.aten.backward"} <= inner


def test_one_splat_span_a_splat_call(traced):
    forwards = _named(traced, "artist.kernels.splat_forward")
    backwards = _named(traced, "artist.kernels.splat_backward")
    assert len(forwards) == traced["calls"]["splat_forward_plain"] > 0
    assert len(backwards) == traced["calls"]["splat_backward_plain"]
    assert (len(backwards) > 0) == (traced["kind"] != "alignment")
    calls = _named(traced, "artist.aten.backward")
    assert all(any(_inside(span, call) for call in calls) for span in backwards)
    # A checkpointed chunk's recompute (the surface run's ray chunks) runs its splat forward
    # inside the backward call, and outside the splat's backward span.
    recomputed = [span for span in forwards if any(_inside(span, call) for call in calls)]
    assert (len(recomputed) > 0) == (traced["kind"] == "surface")
    assert not any(_inside(forward, backward) for forward in forwards for backward in backwards)


def _split(reconstructor):
    group = reconstructor.scenario.heliostat_groups[0]
    return training.group_calibration_split(
        reconstructor.data, reconstructor.scenario, group, reconstructor.bitmap_resolution
    )


def test_transfers_count_the_split_arrays_bytes(traced):
    unique, split = _split(traced["reconstructor"])
    surface = traced["kind"] == "surface"
    expected = 0
    for part in ("train", "test"):
        def array(name, dtype=None):
            return np.asarray(getattr(split, f"{name}_{part}"), dtype=dtype)

        mask = array("active_heliostats_mask")
        samples = int(mask.sum())
        counts = mask[unique]
        rows, width = len(unique), max(1, int(counts.max()))
        expected += samples * 4  # the sample -> heliostat map, int32
        expected += rows * width * (4 + 1)  # the reduction's int32 indices and their bool validity
        expected += array("target_area_indices").nbytes
        if surface:
            expected += array("incident_ray_directions", np.float32).nbytes + array("flux_measured", np.float32).nbytes
            expected += np.asarray(unique).nbytes  # the rows' heliostats
        else:
            expected += sum(array(name).nbytes for name in (
                "incident_ray_directions", "focal_spots_measured", "flux_measured", "motor_positions"))
    assert expected > SIZE["heliostats"] * SIZE["samples"] * 32 * 32 * 4
    assert traced["transfers"] == {"host_to_device_bytes": expected}


def test_to_device_counts_the_host_bytes_and_converts():
    training.reset_transfer_counts()
    tensor = training.to_device(np.arange(6, dtype=np.int32).reshape(2, 3), CPU, torch.long)
    assert tensor.dtype == torch.long and tensor.tolist() == [[0, 1, 2], [3, 4, 5]]
    training.to_device(np.zeros(5, np.bool_), CPU)
    assert training.TRANSFERS == {"host_to_device_bytes": 6 * 4 + 5}
    training.reset_transfer_counts()
    assert training.TRANSFERS == {"host_to_device_bytes": 0}



# ---------------------------------------------------------------------------
# The aim-point optimizer's loop: 4 heliostats on dense rows (blocking keeps slots),
# heliostat chunks of 2, 3 epochs, under a CPU profiler.
# ---------------------------------------------------------------------------

AIM_EPOCHS = 2  # max_epoch: 3 epochs a call
BLOCKING_PREFIXES = ("artist.blocking.", "artist.kernels.sigma_")


@pytest.fixture(scope="module")
def aim_traced():
    """One ``optimize()`` call under a CPU profiler: its ``artist.`` spans and its epochs."""
    scenario = chip_smoke.aim_point_scenario(CPU, 4, (3, 3), 2, row_spacing=chip_smoke.DENSE_ROW_SPACING)
    optimizer = chip_smoke.aim_point_optimizer(
        scenario, chip_smoke.aim_point_ground_truth((32, 32), CPU), AIM_EPOCHS, 16, (32, 32), heliostat_chunk=2
    )
    epochs: list[int] = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
        optimizer.optimize(on_epoch=lambda epoch, loss: epochs.append(epoch))
    spans = [
        (event.name(), event.start_ns(), event.start_ns() + event.duration_ns())
        for event in profiler.profiler.kineto_results.events()
        if event.name().startswith("artist.")
    ]
    return dict(spans=spans, epochs=epochs)


def test_aim_point_spans_nest_as_in_the_reconstructors(aim_traced):
    (call,) = _named(aim_traced, "artist.entry.call")
    (preamble,) = _named(aim_traced, "artist.entry.preamble")
    assert _inside(preamble, call)
    epochs = _named(aim_traced, "artist.optim.epoch")
    assert len(aim_traced["epochs"]) == AIM_EPOCHS + 1
    assert len(epochs) == len(aim_traced["epochs"]) == len(_named(aim_traced, "artist.optim.fetch"))
    assert all(_inside(epoch, call) and epoch[1] >= preamble[2] for epoch in epochs)
    # The epoch-0 references trace inside the preamble.
    assert any(_inside(span, preamble) for span in _named(aim_traced, "artist.aten.trace"))
    outers = epochs + [preamble]
    layered = [span for span in aim_traced["spans"]
               if span[0].startswith(LAYER_PREFIXES + ("artist.blocking.", "artist.optim.update"))]
    assert all(any(_inside(span, outer) for outer in outers) for span in layered)
    for epoch in epochs:
        inner = {span[0] for span in aim_traced["spans"] if _inside(span, epoch) and span != epoch}
        assert {"artist.optim.update", "artist.optim.fetch", "artist.aten.trace", "artist.aten.align",
                "artist.aten.loss", "artist.aten.backward"} <= inner


def test_aim_point_host_partition_sums_to_the_epochs(aim_traced):
    from benchmark import spans as bench_spans
    from benchmark import trace as bench_trace

    start = min(span[1] for span in aim_traced["spans"])
    host = [(name, (begin - start) * 1e-9, (end - start) * 1e-9) for name, begin, end in aim_traced["spans"]]
    trace = bench_trace.Trace(device=[], runtime=[], host=host, start=0.0, end=max(end for _, _, end in host),
                              epochs=len(aim_traced["epochs"]))
    self_s, waits_s, epochs_s = bench_spans.epoch_partition(trace)
    assert waits_s == 0.0 and epochs_s > 0
    assert sum(self_s.values()) == pytest.approx(epochs_s, rel=1e-9)
    assert {"artist.blocking.candidates", "artist.kernels.sigma_forward", "artist.kernels.sigma_backward"} <= set(self_s)


def test_aim_point_blocking_spans_sit_inside_the_trace_or_the_backward(aim_traced):
    traces, backwards = _named(aim_traced, "artist.aten.trace"), _named(aim_traced, "artist.aten.backward")
    blocking = [span for span in aim_traced["spans"] if span[0].startswith(BLOCKING_PREFIXES)]
    assert {span[0] for span in blocking} == {
        "artist.blocking.mask", "artist.blocking.primitives", "artist.blocking.candidates",
        "artist.kernels.sigma_forward", "artist.kernels.sigma_backward"}
    assert all(any(_inside(span, outer) for outer in traces + backwards) for span in blocking)
    # Each epoch's backward runs each chunk's sigma backward, and recomputes its forward first.
    for kind in ("artist.kernels.sigma_backward", "artist.kernels.sigma_forward"):
        recomputed = [span for span in _named(aim_traced, kind) if any(_inside(span, b) for b in backwards)]
        assert len(recomputed) == 2 * len(aim_traced["epochs"]), kind
