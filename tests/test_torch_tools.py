"""The port's tools ``artist_tpu_torch.tools.memory_report`` and ``ablate_step`` on the CPU.

``memory_report``'s count of the bytes autograd saves for the backward must grow
linearly with the heliostats (every per-ray tensor of the step has a heliostat
axis) and fall with ``heliostat_chunk`` (each chunk runs under a checkpoint, which
saves nothing for its backward but recomputes it); ``ablate_step`` must give three
finite times at a tiny size, the full forward and backward no faster than the
forward alone. Their numbers on the CPU are the CPU's, not the card's.
"""

import numpy as np
import pytest

from artist_tpu_torch.tools import ablate_step, memory_report

TINY = dict(rays=4, surface_points=5, ray_chunk=2)


@pytest.mark.parametrize("blocking", [False, True])
def test_saved_bytes_grow_linearly_with_heliostats_and_fall_with_chunks(blocking):
    saved = {
        heliostats: memory_report.memory_report("cpu", heliostats, blocking=blocking, **TINY)["saved_bytes"]
        for heliostats in (4, 8, 16)
    }
    increments = np.diff([saved[4], saved[8], saved[16]]) / np.diff([4, 8, 16])
    np.testing.assert_allclose(increments[1], increments[0], rtol=0.02)
    assert increments[0] > 0
    chunked = memory_report.memory_report("cpu", 16, heliostat_chunk=4, blocking=blocking, **TINY)
    assert chunked["saved_bytes"] < saved[16] / 10
    assert chunked["max_memory_allocated"] is None and np.isfinite(chunked["loss"])


def test_memory_report_command_line(capsys):
    report = memory_report.main(["--heliostats", "4", "--rays", "4", "--surface-points", "5", "--ray-chunk", "2",
                                 "--blocking", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "saved for the backward" in printed and "blocking=ON K=16" in printed
    assert report["saved_bytes"] > report["input_bytes"] > 0


@pytest.mark.parametrize("block_window", [None, 16])
def test_ablate_step_gives_three_finite_times(block_window):
    times = ablate_step.ablate("cpu", heliostats=4, surface_points=(10, 10), rays=4, ray_chunk=2,
                               block_window=block_window, steps=2)
    assert all(np.isfinite(times[key]) and times[key] > 0 for key in ("full", "forward", "geometry"))
    assert times["full"] >= times["forward"]
    assert times["rays"] == 4 * 4 * 400
