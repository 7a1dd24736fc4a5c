"""The port's multi-process modes in real two-rank gloo worlds on the CPU.

Each world is two processes of ``tests/torch_distributed_worker.py`` (a free
port each time, a 180 s limit a process, a 120 s limit a collective); the world
of one runs in this process with a one-rank setup. The worker runs the three
optimizers at the JAX package's worker size and returns their losses,
histories, parameters and first objective gradients (surface: control points;
kinematics, both methods: rotation deviations; aim point: the tanh parameters
of the motor positions, on a field whose rows block each other across groups).

- World 2 against world 1 (the port), to the JAX package's own tolerances
  (``tests/parallel/test_distributed.py``): group-parallel (two groups)
  losses 1e-5 relative (aim point 1e-4), control points and rotation
  deviations 1e-6, motor positions 1e-3, factors 1e-5 absolute; nested (one
  group, mesh ``(2, 1)``, and ``(1, 2)`` with the rays split) losses 1e-4
  relative, parameters 1e-5 absolute. The first gradients to 1e-4 relative
  (plus 1e-6 of their largest entry): a backward that sums a replicated
  cotangent over the ranks doubles them, which Adam's scale-free step hides
  from the parameters. The two ranks agree bit for bit.
- Per-rank checkpoints commit under ``surface_group_{g}``,
  ``kinematics_group_{g}`` and ``aim_point_rank{r}``, and a world of one
  resuming them raises.

World 1 against the JAX package and the rehearsal of ``chip_smoke.py`` phase 16 are in
``test_torch_distributed_world_of_one.py`` and ``test_torch_distributed_phase_16.py``, so
that the three files run on three workers.
"""

import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import torch_distributed_worker as worker
from artist_tpu_torch.io.checkpoint import CheckpointManager
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.util import constants

WORKER = pathlib.Path(worker.__file__)
CPU = torch.device("cpu")
PROCESS_TIMEOUT = 180
SEED = 7
METHODS = worker.KINEMATICS_METHODS
RAYTRACING, ALIGNMENT = METHODS


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _world_of_two(tmp_path, groups: int, mesh_shape=None, checkpoint_dir=None) -> list[dict]:
    """Both ranks' results of a two-process world of the worker."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outputs = [tmp_path / f"rank{rank}.pkl" for rank in range(2)]
    processes = []
    for rank, output in enumerate(outputs):
        command = [
            sys.executable, str(WORKER), "--output", str(output), "--groups", str(groups),
            "--coordinator", coordinator, "--num-processes", "2", "--process-id", str(rank),
        ]
        if mesh_shape is not None:
            command += ["--mesh-shape", *map(str, mesh_shape)]
        if checkpoint_dir is not None:
            command += ["--checkpoint-dir", str(checkpoint_dir)]
        processes.append(subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [process.communicate(timeout=PROCESS_TIMEOUT)[0] for process in processes]
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
                process.wait()
    for rank, (process, log_text) in enumerate(zip(processes, logs)):
        assert process.returncode == 0, f"rank {rank} failed:\n{log_text[-4000:]}"
    results = []
    for output in outputs:
        with open(output, "rb") as handle:
            results.append(pickle.load(handle))
    return results


def _world_of_one(groups: int, **options) -> dict:
    with setup_distributed_environment(groups, device="cpu") as setup:
        assert not setup.is_distributed and setup.world_size == 1
        return worker.run(setup, groups, **options)


@pytest.fixture(scope="module")
def data():
    return worker.kinematics_data()


@pytest.fixture(scope="module")
def world_one(data):
    return {groups: _world_of_one(groups, data=data) for groups in (1, 2)}


@pytest.fixture(scope="module")
def group_parallel(tmp_path_factory):
    root = tmp_path_factory.mktemp("group_parallel")
    return _world_of_two(root, 2, checkpoint_dir=root / "checkpoints"), root / "checkpoints"


@pytest.fixture(scope="module")
def nested(tmp_path_factory):
    return {
        "samples": _world_of_two(tmp_path_factory.mktemp("nested"), 1),
        "rays": _world_of_two(tmp_path_factory.mktemp("nested_rays"), 1, mesh_shape=(1, 2)),
    }


def _losses(prefix: str, groups: int) -> list[str]:
    keys = [f"{prefix}_final_loss"] + [f"{prefix}_history_{g}" for g in range(groups)]
    return keys if prefix != "aim_point" else ["aim_point_final_loss", "aim_point_history_total_loss",
                                                "aim_point_history_flux_loss"]


def _gradient(ours: np.ndarray, reference: np.ndarray, what: str) -> None:
    scale = np.abs(reference).max()
    assert scale > 0, what
    np.testing.assert_allclose(ours, reference, rtol=1e-4, atol=1e-6 * scale, err_msg=what)


# --------------------------------------------------------------------------- #
# World 2 against world 1.
# --------------------------------------------------------------------------- #

OPTIMIZERS = ("surface", RAYTRACING, ALIGNMENT, "aim_point")
PARAMETERS = {
    "surface": ("surface_control_points", 1e-6),
    RAYTRACING: (f"{RAYTRACING}_rotation_deviations", 1e-6),
    ALIGNMENT: (f"{ALIGNMENT}_rotation_deviations", 1e-6),
    "aim_point": ("aim_point_motor_positions", 1e-3),
}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_group_parallel_matches_one_process(group_parallel, world_one, optimizer):
    """Each rank runs one of the two groups; after the merge both hold the whole field."""
    pair, _ = group_parallel
    single = world_one[2]
    for result in pair:
        assert result["world_size"] == 2 and not result["is_nested"]
        if optimizer != "aim_point":
            assert list(result[f"{optimizer}_groups"]) == [0, 1]
        for key in _losses(optimizer, 2):
            np.testing.assert_allclose(
                result[key], single[key], rtol=1e-4 if optimizer == "aim_point" else 1e-5, err_msg=key
            )
        name, atol = PARAMETERS[optimizer]
        for g in range(2):
            np.testing.assert_allclose(result[f"{name}_{g}"], single[f"{name}_{g}"], rtol=0, atol=atol)
        if optimizer == "surface":
            for g in range(2):
                np.testing.assert_allclose(result[f"surface_points_{g}"], single[f"surface_points_{g}"], atol=1e-6)
        if optimizer == "aim_point":
            for key in ("aim_point_intercepts", "aim_point_on_targets", "aim_point_blockings"):
                np.testing.assert_allclose(result[key], single[key], rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_group_parallel_gradient_matches_one_process(group_parallel, world_one, optimizer):
    pair, _ = group_parallel
    prefix = "surface" if optimizer == "surface" else optimizer
    for result in pair:
        for g in range(2):
            key = f"{prefix}_gradient_{g}"
            _gradient(result[key], world_one[2][key], key)


def test_group_parallel_blocking_crosses_the_ranks(world_one):
    """The aim-point field blocks: some heliostat of one group loses rays to the other's."""
    assert world_one[2]["aim_point_blockings"].min() < 1.0


@pytest.mark.parametrize("split", ["samples", "rays"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_nested_matches_one_process(nested, world_one, optimizer, split):
    """One group, two ranks: samples (or rays) split over the mesh, the global loss."""
    single = world_one[1]
    for result in nested[split]:
        assert result["is_nested"] and result["world_size"] == 2
        for key in _losses(optimizer, 1):
            np.testing.assert_allclose(result[key], single[key], rtol=1e-4, err_msg=key)
        name, _ = PARAMETERS[optimizer]
        atol = 1e-5 if optimizer != "aim_point" else 1e-3
        np.testing.assert_allclose(result[f"{name}_0"], single[f"{name}_0"], rtol=0, atol=atol)
        if optimizer == "aim_point":
            for key in ("aim_point_intercepts", "aim_point_on_targets", "aim_point_blockings"):
                np.testing.assert_allclose(result[key], single[key], rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("split", ["samples", "rays"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_nested_gradient_matches_one_process(nested, world_one, optimizer, split):
    prefix = "surface" if optimizer == "surface" else optimizer
    for result in nested[split]:
        key = f"{prefix}_gradient_0"
        _gradient(result[key], world_one[1][key], key)


@pytest.mark.parametrize("mode", ["group_parallel", "samples", "rays"])
def test_the_ranks_agree_exactly(group_parallel, nested, mode):
    pair = group_parallel[0] if mode == "group_parallel" else nested[mode]
    assert [result["rank"] for result in pair] == [0, 1]
    assert set(pair[0]) == set(pair[1])
    for key in pair[0]:
        if key != "rank":
            np.testing.assert_array_equal(np.asarray(pair[0][key]), np.asarray(pair[1][key]), err_msg=key)


@pytest.mark.parametrize("mode", ["group_parallel", "samples", "rays"])
def test_host_collectives_and_a_sharded_round_trip(group_parallel, nested, mode):
    """``all_gather_object``, ``broadcast_object``, ``all_reduce_min``/``_sum`` and ``barrier``
    in a world of two, and ``put_global`` / ``fetch_global`` of a ``[4, 6, 5]`` tensor over
    its mesh: halved along the split dim, whole again after the gather."""
    pair = group_parallel[0] if mode == "group_parallel" else nested[mode]
    split = {"group_parallel": (2, 6), "samples": (2, 6), "rays": (4, 3)}[mode]
    for result in pair:
        np.testing.assert_array_equal(result["exchange_gathered_ranks"], [0, 1])
        assert int(result["exchange_broadcast_from_last"]) == 1
        np.testing.assert_array_equal(result["exchange_minimum"], [0.0, -1.0])
        np.testing.assert_array_equal(result["exchange_sum"], [1.0, 2.0])
        np.testing.assert_array_equal(result["exchange_local_shape"], [*split, 5])
        np.testing.assert_array_equal(result["exchange_round_trip"], np.arange(120.0).reshape(4, 6, 5))


# --------------------------------------------------------------------------- #
# Checkpoints.
# --------------------------------------------------------------------------- #

LABELS = ["surface_group_0", "surface_group_1", "kinematics_group_0", "kinematics_group_1",
          "aim_point_rank0", "aim_point_rank1"]


@pytest.mark.parametrize("label", LABELS)
def test_per_rank_checkpoints_commit(group_parallel, label):
    _, checkpoint_dir = group_parallel
    manager = CheckpointManager(checkpoint_dir / label)
    assert manager.latest_step == worker.MAX_EPOCH
    restored = manager.restore()
    assert int(restored["world_size"]) == 2 and int(restored["epoch"]) == worker.MAX_EPOCH


@pytest.mark.parametrize("optimizer", ["surface", RAYTRACING, "aim_point"])
def test_resuming_under_another_world_size_raises(group_parallel, data, optimizer, tmp_path):
    """The world of two's checkpoints, resumed by a world of one: an error, not epoch 0."""
    _, checkpoint_dir = group_parallel
    with setup_distributed_environment(2, device="cpu") as setup:
        options = dict(checkpoint_dir=checkpoint_dir, checkpoint_every=1, distributed_setup=setup)
        with pytest.raises(ValueError, match="world size"):
            if optimizer == "surface":
                worker.SurfaceReconstructor(
                    worker.surface_scenario(2),
                    {constants.data_parser: worker.SyntheticCalibrationParser(2), constants.heliostat_data_mapping: []},
                    worker.SURFACE_CONFIGURATION, number_of_surface_points=worker.POINTS,
                    bitmap_resolution=worker.BITMAP, **options,
                ).reconstruct_surfaces()
            elif optimizer == RAYTRACING:
                worker.KinematicsReconstructor(
                    worker.surface_scenario(2),
                    {constants.data_parser: chip_smoke.CalibrationSamples(data), constants.heliostat_data_mapping: []},
                    worker.KINEMATICS_CONFIGURATION, reconstruction_method=RAYTRACING,
                    bitmap_resolution=worker.BITMAP, **options,
                ).reconstruct_kinematics()
            else:
                worker.aim_point_optimizer(worker.aim_point_scenario(2), **options).optimize("kl_divergence")
