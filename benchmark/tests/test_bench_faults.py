"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the port and the rest of a run is driven on the CPU at a
tiny size (the look for a card skipped): a step that returns its state unchanged
(Adam's update left out), half of the batch left out and the mean taken over the
rest (per heliostat), and an answer altered where it is produced (a flux map or a
normal, as the workload file's faults name it). The cells run on one card: there is
no exchange between cards to leave out.
"""

from __future__ import annotations

import pytest
import torch
import torch.optim.adam as torch_adam

import artist_tpu_torch.field.kinematics_rigid_body as rigid_body
import artist_tpu_torch.optim.losses as port_losses
import artist_tpu_torch.raytracing.render as port_render
from benchmark import run

from conftest import TINY_SEED

CELLS = ("surface12.reconstruct", "field100.kinematics_raytracing", "field100.kinematics_alignment")
FAULTS = ("state_unchanged", "half_batch", "answer")


def plant(monkeypatch, fault: str, cell: str) -> None:
    if fault == "state_unchanged":
        monkeypatch.setattr(torch_adam, "adam", lambda *args, **kwargs: None)
    elif fault == "half_batch":
        reduce = port_losses.reduce_loss_per_heliostat

        def half(*args, **kwargs):
            per_heliostat = reduce(*args, **kwargs)
            kept = per_heliostat.shape[0] // 2
            return torch.cat([2.0 * per_heliostat[:kept], 0.0 * per_heliostat[kept:]])

        monkeypatch.setattr(port_losses, "reduce_loss_per_heliostat", half)
    elif cell == "field100.kinematics_raytracing":
        splat = port_render.bilinear_splat
        monkeypatch.setattr(port_render, "bilinear_splat",
                            lambda *args, **kwargs: torch.roll(splat(*args, **kwargs), 1, dims=-1))
    elif cell == "surface12.reconstruct":
        splat = port_render.bilinear_splat

        def first_map_zeroed(*args, **kwargs):
            maps = splat(*args, **kwargs)
            keep = torch.ones_like(maps)
            keep[0] = 0.0
            return maps * keep

        monkeypatch.setattr(port_render, "bilinear_splat", first_map_zeroed)
    else:
        orientations = rigid_body.motor_positions_to_orientations

        def first_normal_zeroed(*args, **kwargs):
            out = orientations(*args, **kwargs)
            keep = torch.ones_like(out)
            keep[0, :, 2] = 0.0
            return out * keep

        monkeypatch.setattr(rigid_body, "motor_positions_to_orientations", first_normal_zeroed)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    sound = run.run_cell(tiny_root, cell, TINY_SEED, 0.2, False, torch.device("cpu"))
    plant(monkeypatch, fault, cell)
    broken = run.run_cell(tiny_root, cell, TINY_SEED, 0.2, False, torch.device("cpu"))
    assert not broken["correct"]
    # The fault shows far past the sound run's reading, also where the CPU's own reading
    # of a number is above its card limit (see test_bench_reference).
    checked = broken["checked"]
    failing = [name for name, item in checked.items() if not float(item["value"]) <= item["limit"]]
    assert any(not float(checked[name]["value"]) <= 10 * sound["checked"][name]["value"] for name in failing), checked
