"""``chip_smoke.py`` phase 16 rehearsed on the CPU in this process, at a small size: its
launch counts against the plain versions' calls, and its world-of-one runs.

Split from ``test_torch_distributed.py`` with ``test_torch_distributed_world_of_one.py``, so
that the three files run on three workers; the checks are the same.
"""

import sys

import pytest
import torch

import chip_smoke
import torch_distributed_worker as worker
from artist_tpu_torch.kernels import blocking as blocking_kernels
from artist_tpu_torch.parallel import setup_distributed_environment

CPU = torch.device("cpu")
RAYTRACING, ALIGNMENT = worker.KINEMATICS_METHODS
OPTIMIZERS = ("surface", RAYTRACING, ALIGNMENT, "aim_point")


# --------------------------------------------------------------------------- #
# chip_smoke.py phase 16, rehearsed in this process at a small size.
# --------------------------------------------------------------------------- #

SPLAT = sys.modules["artist_tpu_torch.kernels.splat"]
# Each kernel the three optimizers launch, by its plain version (the CPU runs it in the kernel's place).
PLAIN = {
    "splat_forward": (SPLAT, "splat_forward_plain"),
    "splat_backward": (SPLAT, "splat_backward_plain"),
    "blocking_sigma_forward": (blocking_kernels, "sigma_forward_plain"),
    "blocking_sigma_backward": (blocking_kernels, "sigma_backward_plain"),
}


@pytest.fixture
def small_phase_16(monkeypatch):
    """Phase 16's fields cut to CPU size (the rays, chunks and epochs kept): 4 heliostats a
    reconstruction at 5 x 5 points and 32 x 32 maps, 16 plant heliostats in chunks of 4;
    and counts of the plain versions' calls, by kernel."""
    from artist_tpu_torch.examples import plant_scale_aim_points

    monkeypatch.setattr(chip_smoke, "RECON_HELIOSTATS", 4)
    monkeypatch.setattr(chip_smoke, "RECON_SURFACE_POINTS", (5, 5))
    monkeypatch.setattr(chip_smoke, "BITMAP", (32, 32))
    monkeypatch.setattr(chip_smoke, "KINEMATICS", dict(heliostats=4, samples=4, surface_points=(5, 5), rays=3,
                                                       bitmap=(32, 32)))
    monkeypatch.setattr(plant_scale_aim_points, "HELIOSTATS", 16)
    monkeypatch.setattr(plant_scale_aim_points, "POINTS", 3)
    monkeypatch.setattr(chip_smoke, "DISTRIBUTED_PLANT_CHUNK", 4)
    calls = dict.fromkeys(chip_smoke.KERNELS, 0)
    for name, (module, attribute) in PLAIN.items():
        original = getattr(module, attribute)

        def counted(*args, _name=name, _original=original, **kwargs):
            calls[_name] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, attribute, counted)
    size = chip_smoke.KINEMATICS
    known = chip_smoke.known_rotation_deviations(size["heliostats"])
    data = chip_smoke.kinematics_calibration(chip_smoke.kinematics_scenario(CPU, size), known, size["samples"],
                                             size["bitmap"])
    calls.update(dict.fromkeys(calls, 0))  # the samples' own trace is not the path's
    return calls, data


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_chip_smoke_phase_16_launch_counts(small_phase_16, optimizer, groups):
    """Each optimizer's call as phase 16 makes it, its kernels counted by their plain
    versions' calls against ``chip_smoke.distributed_launches`` (the card's assertion)."""
    calls, data = small_phase_16
    run = chip_smoke.distributed_optimizer(CPU, optimizer, groups, None, data)
    epochs = []
    if optimizer == "surface":
        run.reconstruct_surfaces("kl_divergence", on_epoch=lambda epoch, loss: epochs.append(epoch))
    elif optimizer == "aim_point":
        run.optimize("kl_divergence", on_epoch=lambda epoch, loss: epochs.append(epoch))
    else:
        with chip_smoke.deterministic_algorithms():
            run.reconstruct_kinematics(on_epoch=lambda epoch, loss: epochs.append(epoch))
    chunks = 4 if optimizer == "aim_point" and groups == 2 else 1  # 2 groups of 8 in chunks of 4
    assert epochs.count(0) == (1 if optimizer == "aim_point" else groups)
    assert calls == chip_smoke.distributed_launches(optimizer, groups, epochs, chunks)


def test_chip_smoke_phase_16_world_of_one_on_the_cpu(small_phase_16):
    """Phase 16's runs of a world of one on the CPU, without a setup and with a one-rank
    gloo setup: every run's record, and gaps of 0 between the two (the CPU is deterministic)."""
    _, data = small_phase_16
    for name in chip_smoke.DISTRIBUTED_OPTIMIZERS:
        plain = chip_smoke.run_distributed(CPU, name, 2, None, data)
        with setup_distributed_environment(2, device="cpu") as setup:
            with_setup = chip_smoke.run_distributed(CPU, name, 2, setup, data)
        gaps = chip_smoke.distributed_gaps(with_setup, plain)
        limits = chip_smoke.distributed_limits(name, chip_smoke.GROUP_PARALLEL_TOLERANCE)
        assert not chip_smoke.distributed_gap_failures("rehearsal", name, gaps, limits)
        assert all(gap == 0 for gap in gaps.values()), (name, gaps)
        assert len(plain["gradients"]) == len(plain["parameters"]) == 2
        assert len(plain["epoch_seconds"]) == len(plain["collective_seconds"]) > 0
        assert with_setup["collective_calls"] == 0  # one rank: nothing reaches the process group
