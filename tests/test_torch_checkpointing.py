"""Checkpoint and resume of the port's three optimizers, and the checkpoint files.

The contract, as the JAX package's ``tests/optim/test_checkpointing.py`` states
it for its optimizers: a run stopped after a checkpoint and resumed from it
reaches the same state as a run straight through. Each optimizer here runs on
the port's synthetic field on the CPU: straight through 6 epochs (max_epoch 5),
then 4 epochs (max_epoch 3) saving every 2, then 6 again in the same
directory, which resume from epoch 2. The histories, the final parameters and
losses must be equal bit for bit: the CPU runs the same operations on the
same inputs in the same order, and the checkpoint restores every piece of the
loop's state exactly (numpy arrays of the tensors, Python floats as float64).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu_torch.io.checkpoint import CheckpointManager
from artist_tpu_torch.optim import checkpointing
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.scenario.synthetic import SyntheticCalibrationParser, make_synthetic_scenario
from artist_tpu_torch.util import constants

CPU = torch.device("cpu")
MAX_EPOCHS = (3, 5)  # the stopped run's, and the straight and the resumed run's
EVERY = 2


def _plateau(patience: int = 1) -> dict:
    """Reduce-on-plateau that cuts the rate within the 6 epochs, so that its state matters."""
    return {
        constants.scheduler_type: constants.reduce_on_plateau,
        constants.lr_min: 1e-6,
        constants.reduce_factor: 0.5,
        constants.patience: patience,
        constants.threshold: 0.5,
        constants.cooldown: 1,
    }


def _runs(tmp_path, run):
    """``run(checkpoint_dir, max_epoch)`` straight through, and stopped then resumed."""
    straight = run(tmp_path / "straight", MAX_EPOCHS[1])
    run(tmp_path / "resumed", MAX_EPOCHS[0])
    assert sorted(p.name for p in (tmp_path / "resumed").glob("*/*.npz")) == ["2.npz"]
    resumed = run(tmp_path / "resumed", MAX_EPOCHS[1])
    return straight, resumed


def _assert_equal(straight, resumed):
    for key in straight:
        if isinstance(straight[key], dict):
            assert set(straight[key]) == set(resumed[key]), key
            for name in straight[key]:
                np.testing.assert_array_equal(resumed[key][name], straight[key][name], err_msg=f"{key} {name}")
        else:
            np.testing.assert_array_equal(resumed[key], straight[key], err_msg=key)


def test_surface_reconstruction_resumes_identically(tmp_path):
    def run(directory, max_epoch):
        scenario = make_synthetic_scenario(
            number_of_heliostats=3, number_of_control_points_per_facet=(5, 5),
            number_of_surface_points_per_facet=(6, 6), number_of_rays=4, device=CPU,
        )
        configuration = chip_smoke.reconstruction_configuration(max_epoch)
        configuration[constants.scheduler] = _plateau()
        reconstructor = SurfaceReconstructor(
            scenario,
            {constants.data_parser: SyntheticCalibrationParser(samples_per_heliostat=4),
             constants.heliostat_data_mapping: []},
            configuration, number_of_surface_points=(6, 6), bitmap_resolution=(32, 32), ray_chunk=2,
            checkpoint_dir=directory, checkpoint_every=EVERY,
        )
        final, (result,) = reconstructor.reconstruct_surfaces()
        group = scenario.heliostat_groups[0]
        return {
            "history": result.loss_history,
            "test_loss": result.test_loss,
            "final": final,
            "control_points": group.nurbs_control_points.numpy(),
            "surface_points": group.surface_points.numpy(),
        }

    straight, resumed = _runs(tmp_path, run)
    assert len(straight["history"]["total_loss"]) == MAX_EPOCHS[1] + 1
    _assert_equal(straight, resumed)


@pytest.mark.parametrize(
    "method", [constants.kinematics_reconstruction_alignment, constants.kinematics_reconstruction_raytracing]
)
def test_kinematics_reconstruction_resumes_identically(tmp_path, method):
    size = dict(heliostats=3, samples=4, surface_points=(4, 4), rays=4, bitmap=(32, 32))
    known = chip_smoke.known_rotation_deviations(size["heliostats"])
    data = chip_smoke.kinematics_calibration(chip_smoke.kinematics_scenario(CPU, size), known, 4, size["bitmap"])

    def run(directory, max_epoch):
        configuration = chip_smoke.kinematics_configuration(max_epoch)
        configuration[constants.scheduler] = _plateau()
        reconstructor = chip_smoke.kinematics_reconstructor(
            CPU, size, data, method, configuration, checkpoint_dir=directory, checkpoint_every=EVERY
        )
        final, (result,) = reconstructor.reconstruct_kinematics()
        return {
            "history": np.asarray(result.loss_history),
            "final": final,
            "deviations": reconstructor.scenario.heliostat_groups[0].rotation_deviations.numpy(),
        }

    straight, resumed = _runs(tmp_path, run)
    assert len(straight["history"]) == MAX_EPOCHS[1] + 1
    assert np.abs(straight["deviations"]).max() > 0
    _assert_equal(straight, resumed)


def test_aim_point_optimization_resumes_identically(tmp_path):
    ground_truth = chip_smoke.aim_point_ground_truth((32, 32), CPU, slope=5, plateau=10)

    def run(directory, max_epoch):
        scenario = chip_smoke.aim_point_scenario(CPU, 4, (4, 4), 4)
        optimizer = chip_smoke.aim_point_optimizer(
            scenario, ground_truth, max_epoch, 16, (32, 32), checkpoint_dir=directory, checkpoint_every=EVERY
        )
        # A maximum flux density the spots exceed, so that the local-flux multiplier grows.
        optimizer.constraint_dict = {**optimizer.constraint_dict, constants.max_flux_density: 1e3}
        loss, history, intercepts, on_targets, blockings = optimizer.optimize("kl_divergence")
        return {
            "loss": np.float64(loss),
            "history": history,
            "factors": np.concatenate([intercepts.numpy(), on_targets.numpy(), blockings.numpy()]),
            "motors": scenario.heliostat_groups[0].motor_positions.numpy(),
        }

    straight, resumed = _runs(tmp_path, run)
    assert all(len(values) == MAX_EPOCHS[1] + 1 for values in straight["history"].values())
    assert min(straight["history"]["local_flux_constraint"][1:]) > 0
    _assert_equal(straight, resumed)


@pytest.mark.parametrize("max_to_keep", [0, -1])
def test_max_to_keep_below_one_is_refused(tmp_path, max_to_keep):
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(tmp_path, max_to_keep=max_to_keep)
    with pytest.raises(ValueError, match="max_to_keep"):
        checkpointing.LoopCheckpointer(tmp_path, "loop", max_to_keep=max_to_keep)


def test_steps_sort_numerically_and_prune(tmp_path):
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (9, 10, 100, 2):
        manager.save(step, {"value": np.float64(step)})
    # The two highest steps survive each save; 2 was saved last and is pruned at once.
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["10.npz", "100.npz"]
    assert manager.latest_step == 100
    assert float(manager.restore()["value"]) == 100.0
    assert float(manager.restore(10)["value"]) == 10.0
    assert manager.restore(9) is None


def test_torn_temporary_file_is_never_a_step(tmp_path):
    manager = CheckpointManager(tmp_path)
    (tmp_path / "tmp_123_7.npz").write_bytes(b"PK\x03\x04 torn")
    assert manager.latest_step is None and manager.restore() is None
    manager.save(2, {"nested": {"a": np.arange(3)}, "b": np.float32(1.5)})
    (tmp_path / "tmp_123_9.npz").write_bytes(b"PK\x03\x04 torn")
    assert manager.latest_step == 2
    restored = manager.restore()
    np.testing.assert_array_equal(restored["nested"]["a"], np.arange(3))
    assert float(restored["b"]) == 1.5
    # A save replaces its file whole, with no temporary name left behind.
    manager.save(4, {"b": np.float32(2.5)})
    assert {p.name for p in tmp_path.glob("*.npz")} == {"2.npz", "4.npz", "tmp_123_7.npz", "tmp_123_9.npz"}


def test_pytree_round_trip():
    parameter = torch.zeros(3, 2, requires_grad=True)
    optimizer = torch.optim.Adam([parameter], lr=1e-3, eps=1e-8)
    fresh = optimizer.state_dict()
    parameter.grad = torch.arange(6.0).reshape(3, 2)
    optimizer.step()
    tree = {
        "optimizer": optimizer.state_dict(),
        "fresh": fresh,
        "tuple": (torch.tensor(1.5), torch.ones(2, dtype=torch.float64), None),
        "list": [1, 2.5, True, np.arange(4, dtype=np.int32)],
        "empty": {"dict": {}, "list": [], "tuple": ()},
    }
    back = checkpointing.unpack_pytree(checkpointing.pack_pytree(tree))
    assert back["fresh"] == fresh and back["empty"] == tree["empty"]
    assert back["list"][:3] == [1, 2.5, True] and type(back["list"][0]) is int and type(back["list"][2]) is bool
    np.testing.assert_array_equal(back["list"][3], tree["list"][3])
    assert back["tuple"][2] is None and back["tuple"][1].dtype == torch.float64
    state = tree["optimizer"]["state"][0]
    assert set(back["optimizer"]["state"]) == {0}
    for key, value in state.items():
        assert torch.equal(back["optimizer"]["state"][0][key], value), key
    assert back["optimizer"]["param_groups"] == tree["optimizer"]["param_groups"]
    # The unpacked state loads into a fresh optimizer.
    other = torch.optim.Adam([torch.zeros(3, 2, requires_grad=True)], lr=1e-3, eps=1e-8)
    other.load_state_dict(back["optimizer"])
    assert torch.equal(other.state_dict()["state"][0]["exp_avg"], state["exp_avg"])
    assert torch.equal(checkpointing.unpack_pytree(checkpointing.pack_pytree(torch.ones(2))), torch.ones(2))
    with pytest.raises(TypeError):
        checkpointing.pack_pytree({1.5: 0})
    with pytest.raises(ValueError):
        checkpointing.pack_pytree({"a/b": 0})
