"""The program's spans in a trace: self time, the host's waits, the partition of the epochs, the
idle gaps they name, and the readers of the host's time by layer, on records of known times."""

from __future__ import annotations

import importlib

import pytest

from benchmark import spans as tracing_spans
from benchmark import trace as tracing

from conftest import REPO  # noqa: F401  (puts the checkout on the path)
from test_bench_metrics import Run, reader, stretch

EXISTING_TRACE_READERS = ("device.idle_share", "device.events_per_step", "optim.host_syncs_per_step",
                          "aten.device_ms_per_step")
HOST_READERS = ("optim.host_ms_per_step", "aten.host_ms_per_step", "kernels.splat_host_ms_per_step")

# Two epochs after a preamble. Epoch 0 (1.0 to 11.0): the update, the loss, the backward with the
# splat's backward on the engine's thread inside it, the fetch around a stream synchronization.
# Epoch 1 (11.0 to 15.0): a validation whose synchronous copy to the host is a wait, and one
# asynchronous copy that is not.
SPANS = [
    ("artist.entry.call", 0.0, 15.5),
    ("artist.entry.preamble", 0.0, 1.0),
    ("artist.entry.batches", 0.2, 0.8),
    ("artist.aten.align", 0.5, 0.7),  # in the preamble: not an epoch's
    ("artist.optim.epoch", 1.0, 11.0),
    ("artist.optim.update", 1.0, 2.0),
    ("artist.aten.loss", 2.0, 3.0),
    ("artist.aten.backward", 3.0, 9.0),
    ("artist.kernels.splat_backward", 4.0, 6.0),
    ("artist.optim.fetch", 9.0, 10.0),
    ("artist.optim.epoch", 11.0, 15.0),
    ("artist.optim.validate", 11.5, 14.0),
    ("artist.aten.trace", 12.0, 12.5),
]
RUNTIME = [
    ("cudaStreamSynchronize", 9.2, 9.9, 1),
    ("cudaMemcpy", 13.0, 13.6, 2),
    ("cudaMemcpyAsync", 13.7, 13.8, 3),
    ("cudaLaunchKernel", 6.5, 6.6, 4),
]
COPIES = {2: "Memcpy DtoH (Device -> Pageable)", 3: "Memcpy DtoH (Device -> Pinned)"}
EXPECTED_SELF = {
    "artist.optim.epoch": 1.0 + 0.5 + 1.0,  # 10.0 to 11.0; 11.0 to 11.5 and 14.0 to 15.0
    "artist.optim.update": 1.0,
    "artist.aten.loss": 1.0,
    "artist.aten.backward": 4.0,
    "artist.kernels.splat_backward": 2.0,
    "artist.optim.fetch": 1.0 - 0.7,
    "artist.optim.validate": 2.5 - 0.5 - 0.6,
    "artist.aten.trace": 0.5,
}
WAITS = 0.7 + 0.6


def spanned(**changes) -> tracing.Trace:
    values = dict(device=[("k", 0.1, 0.4, "kernel"), ("k", 5.0, 5.5, "kernel")], runtime=RUNTIME,
                  host=[("aten::mul", 2.2, 2.4)] + SPANS, start=0.0, end=16.0, epochs=2, copies=COPIES)
    values.update(changes)
    return tracing.Trace(**values)


def test_spans_are_read_by_their_prefix():
    found = tracing_spans.spans(spanned())
    assert [span[0] for span in found][:3] == ["artist.entry.call", "artist.entry.preamble", "artist.entry.batches"]
    assert len(found) == len(SPANS) and tracing_spans.spans(stretch()) == []


def test_self_time_of_nested_and_cross_thread_spans_less_the_waits():
    self_s, waits, epochs = tracing_spans.epoch_partition(spanned())
    assert self_s == pytest.approx(EXPECTED_SELF)
    assert waits == pytest.approx(WAITS)
    assert epochs == pytest.approx(14.0)


def test_waits_are_the_syncs_that_the_sync_count_counts():
    waits = tracing_spans.sync_waits(spanned())
    assert [name for _, _, name in waits] == ["cudaStreamSynchronize", "cudaMemcpy"]
    assert reader("optim.host_syncs_per_step").read(Run(spanned())) == len(waits) / 2
    assert tracing_spans.syncs_by_span(spanned()) == {"artist.optim.fetch | None": 1, "artist.optim.validate | None": 1}


def test_the_breakdown_reads_the_stages_the_partition_and_the_unnamed_idle():
    found = tracing_spans.breakdown(spanned())
    assert found["stretch_ms_per_step"] == pytest.approx(8e3)
    assert found["spans_in_epochs_per_step"] == pytest.approx(3.5)  # 7 spans inside the 2 epochs
    assert found["preamble_ms"] == pytest.approx({"artist.entry.preamble": 1e3, "artist.entry.batches": 600.0,
                                                  "artist.aten.align": 200.0})
    assert found["preamble_and_epochs_share"] == pytest.approx(15.0 / 16.0)
    assert found["epoch_waits_ms_per_step"] + sum(found["epoch_self_ms_per_step"].values()) == pytest.approx(7e3)
    assert found["idle_unnamed_share"] == 0.0
    # 15.8 to 17.0 lies after the call: the only idle time under no span or operator
    device = [("k", 0.1, 0.4, "kernel"), ("k", 5.0, 5.5, "kernel"), ("k", 15.0, 15.8, "kernel")]
    later = tracing_spans.breakdown(spanned(device=device, end=17.0))
    assert later["idle_unnamed_share"] == pytest.approx(1.2 / (17.0 - 1.6))


def test_the_host_metrics_and_the_waits_sum_to_the_epochs():
    run = Run(spanned())
    values = {name: reader(name).read(run) for name in HOST_READERS}
    assert values["optim.host_ms_per_step"] == pytest.approx(1e3 * (2.5 + 1.0 + 0.3 + 1.4) / 2)
    assert values["aten.host_ms_per_step"] == pytest.approx(1e3 * (1.0 + 4.0 + 0.5) / 2)
    assert values["kernels.splat_host_ms_per_step"] == pytest.approx(1e3 * 2.0 / 2)
    assert sum(values.values()) + 1e3 * WAITS / 2 == pytest.approx(1e3 * 14.0 / 2)


def test_overlapping_siblings_are_counted_once():
    # A span of the engine's thread that outlives its sibling on the loop's: each instant has one owner.
    host = [("artist.optim.epoch", 0.0, 4.0), ("artist.aten.loss", 1.0, 3.0), ("artist.kernels.splat_forward", 2.0, 3.5)]
    self_s, waits, epochs = tracing_spans.epoch_partition(spanned(host=host, runtime=[], epochs=1))
    assert self_s == pytest.approx({"artist.optim.epoch": 1.5, "artist.aten.loss": 1.0,
                                    "artist.kernels.splat_forward": 1.5})
    assert sum(self_s.values()) + waits == pytest.approx(epochs)


def test_the_preamble_reader_sums_the_preambles():
    assert reader("entry.preamble_ms").read(Run(spanned())) == pytest.approx(1e3)


def test_the_readers_read_nothing_without_spans():
    for name in HOST_READERS + ("entry.preamble_ms",):
        assert reader(name).read(Run(stretch())) is None, name
        assert reader(name).read(Run(None)) is None, name


def test_every_existing_reader_reads_the_same_with_spans_present():
    plain = stretch()
    with_spans = stretch(host=plain.host + SPANS)
    for name in EXISTING_TRACE_READERS:
        assert reader(name).read(Run(with_spans)) == reader(name).read(Run(plain)), name
    assert tracing.top_device_ops(with_spans) == tracing.top_device_ops(plain)


def test_idle_gaps_without_spans_are_unchanged_and_with_spans_name_the_stage():
    assert dict(tracing.idle_gaps(stretch())) == pytest.approx(
        {"aten::mul": 2.0, "cudaMemcpyAsync": 1.0, "aten::inner": 3.5})
    device = [("k", 0.1, 0.4, "kernel"), ("k", 5.0, 5.5, "kernel"), ("k", 15.0, 15.8, "kernel")]
    gaps = dict(tracing.idle_gaps(spanned(device=device, end=17.0)))
    # 0.0 to 0.1 in the preamble; 0.4 to 5.0, middle 2.7, under no operator inside the loss (the
    # multiply ended at 2.4); 5.5 to 15.0, middle 10.25, the epoch's own Python after the fetch;
    # 15.8 to 17.0 after the call, outside every span.
    assert gaps == pytest.approx({"artist.entry.preamble": 0.1, "artist.aten.loss": 4.6, "artist.optim.epoch": 9.5,
                                  "no operator on the host": 1.2})


def test_the_transfer_reader_reads_the_programs_counter_over_its_calls(monkeypatch):
    training = importlib.import_module("artist_tpu_torch.optim.training")
    metric = reader("entry.h2d_mb_per_call")
    monkeypatch.setattr(training, "TRANSFERS", {"host_to_device_bytes": 3_000_000})
    assert metric.read(Run(spanned())) == pytest.approx(3.0 / metric.CALLS)
    assert metric.read(Run(None)) is None
    monkeypatch.delattr(training, "TRANSFERS")
    assert metric.read(Run(spanned())) is None
