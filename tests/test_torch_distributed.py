"""The port's multi-process modes in real two-rank gloo worlds on the CPU.

Each world is two processes of ``tests/torch_distributed_worker.py`` (a free
port each time, a 180 s limit a process, a 120 s limit a collective); the world
of one runs in this process with a one-rank setup. The worker runs the three
optimizers at the JAX package's worker size and returns their losses,
histories, parameters and first objective gradients (surface: control points;
kinematics, both methods: rotation deviations; aim point: the tanh parameters
of the motor positions, on a field whose rows block each other across groups).

- World 1 with a ``distributed_setup`` against the JAX package in one process,
  on the JAX worker's scene split into two groups, the port handed JAX's sun
  distortions: losses and histories to about twice the gap measured between the
  packages (``LOSS_RTOL``), and the first gradients likewise (``GRADIENT_LIMIT``).
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
- ``chip_smoke.py`` phase 16 rehearsed at a small size in this process: its
  launch counts against the plain versions' calls, and its world-of-one runs.
"""

import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_distributed_worker as worker
from test_torch_aim_point import _jax_objective
from artist_tpu.optim.aim_point_optimizer import AimPointOptimizer as JaxAimPointOptimizer
from artist_tpu.optim.kinematics_reconstructor import KinematicsReconstructor as JaxKinematicsReconstructor
from artist_tpu.optim.surface_reconstructor import SurfaceReconstructor as JaxSurfaceReconstructor
from artist_tpu.scenario.synthetic import SyntheticCalibrationParser as JaxParser
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.scenario.synthetic import split_into_groups as jax_split_into_groups
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.io.checkpoint import CheckpointManager
from artist_tpu_torch.kernels import blocking as blocking_kernels
from artist_tpu_torch.optim import losses, training
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
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


# --------------------------------------------------------------------------- #
# World 1 against the JAX package.
# --------------------------------------------------------------------------- #


def _as_dict(x):
    import dataclasses

    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _scenes(groups: int = 2):
    """The JAX worker's scene in both packages, split into ``groups`` groups."""
    jax_scenario = jax_synthetic(
        number_of_heliostats=worker.HELIOSTATS, number_of_control_points_per_facet=worker.CONTROL_POINTS,
        number_of_surface_points_per_facet=worker.POINTS, number_of_rays=worker.RAYS,
    )
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position, _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(group) for group in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names, device="cpu",
    )
    if groups == 1:
        return jax_scenario, scenario
    return jax_split_into_groups(jax_scenario, groups), worker.split_into_groups(scenario, groups)


def _batch_distortions(jax_scenario, mask: np.ndarray) -> list[tuple]:
    """JAX's draws of one group's train and test batches (the split of ``mask``)."""
    split = training.train_test_split(mask, *[np.zeros(int(mask.sum()))] * 5)
    counts = (split.active_heliostats_mask_train.sum(), split.active_heliostats_mask_test.sum())
    points = jax_scenario.heliostat_groups[0].surface_points.shape[1]
    sun = jax_scenario.light_sources[0]
    keys = jax.random.split(jax.random.PRNGKey(SEED))
    return [tuple(np.asarray(x) for x in sun.get_distortions(key, points, int(n))) for key, n in zip(keys, counts)]


# The packages' per-sample flux losses differ by up to ~3e-5 of themselves (fp32
# geometry, sums in other orders).
MEDIAN_TIE = 1e-4


def _median_ties(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per heliostat (rows of ``values``): whether the median's sample (the lower
    middle one) lies within ``MEDIAN_TIE`` of itself of a neighbour in sorted order.
    There the packages' rounding can order the two the other way, and the median
    then carries another sample's gradient."""
    tied = np.zeros(len(values), bool)
    for row, (losses_h, valid_h) in enumerate(zip(values, valid)):
        ordered = np.sort(losses_h[valid_h])
        middle = (len(ordered) - 1) // 2
        gaps = np.diff(ordered)[max(middle - 1, 0) : middle + 1]  # to the median's neighbours
        tied[row] = gaps.size > 0 and gaps.min() <= MEDIAN_TIE * abs(ordered[middle])
    return tied


@pytest.fixture(scope="module")
def against_jax(data):
    """The JAX package in one process, and the port in a world of one, on the same scenes."""
    jax_scenario, _ = _scenes()
    surface_batches = _batch_distortions(jax_scenario, np.full(2, 2, np.int32))
    kinematics_batches = _batch_distortions(jax_scenario, np.full(2, worker.KINEMATICS_SAMPLES, np.int32))
    # The worker draws each group's train batch for the first gradients, then each
    # group's train and test batches for the run.
    queued = {
        "surface": lambda scenario: chip_smoke.QueuedDistortions(
            worker.RAYS, surface_batches[:1] * 2 + surface_batches * 2
        ),
        **{
            m: lambda scenario: chip_smoke.QueuedDistortions(
                worker.RAYS, kinematics_batches[:1] * 2 + kinematics_batches * 2
            )
            for m in METHODS
        },
    }
    theirs: dict = {}
    jax_surface_scenario, _ = _scenes()
    surface = JaxSurfaceReconstructor(
        jax_surface_scenario,
        {constants.data_parser: JaxParser(samples_per_heliostat=2), constants.heliostat_data_mapping: []},
        worker.SURFACE_CONFIGURATION, number_of_surface_points=worker.POINTS, bitmap_resolution=worker.BITMAP,
    )
    for g, gradient in surface.single_step_gradients().items():
        theirs[f"surface_gradient_{g}"] = np.asarray(gradient["gradients"])
        theirs[f"surface_first_loss_{g}"] = np.float64(gradient["loss"])
    theirs["surface_final_loss"], results = surface.reconstruct_surfaces("kl_divergence")
    for result in results:
        theirs[f"surface_history_{result.group_index}"] = np.asarray(result.loss_history["total_loss"])
    for method in METHODS:
        jax_kinematics_scenario, _ = _scenes()
        kinematics = JaxKinematicsReconstructor(
            jax_kinematics_scenario,
            {constants.data_parser: chip_smoke.CalibrationSamples(data), constants.heliostat_data_mapping: []},
            worker.KINEMATICS_CONFIGURATION, reconstruction_method=method, bitmap_resolution=worker.BITMAP,
        )
        for g, gradient in kinematics.single_step_gradients().items():
            theirs[f"{method}_gradient_{g}"] = np.asarray(gradient["gradients"])
        theirs[f"{method}_final_loss"], results = kinematics.reconstruct_kinematics()
        for result in results:
            theirs[f"{method}_history_{result.group_index}"] = np.asarray(result.loss_history)

    # The aim point on the JAX worker's own field (rows 12 m apart: nothing blocks, so
    # JAX's CPU blocking route and the port's compacted one agree) and spot.
    jax_aim_scenario, aim_scenario = _scenes()
    keys = jax.random.split(jax.random.PRNGKey(SEED), 2)
    points = jax_aim_scenario.heliostat_groups[0].surface_points.shape[1]
    aim_draws = [
        tuple(np.asarray(x) for x in jax_aim_scenario.light_sources[0].get_distortions(key, points, 2)) for key in keys
    ]
    aim_scenario.light_sources[0] = chip_smoke.QueuedDistortions(worker.RAYS, aim_draws)
    arguments = dict(
        optimization_configuration=worker.AIM_POINT_CONFIGURATION,
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32), target_area_index=0,
        ground_truth=np.ones(worker.BITMAP, np.float32), dni=1000.0, bitmap_resolution=worker.BITMAP,
    )
    jax_aim = JaxAimPointOptimizer(scenario=jax_aim_scenario, **arguments).optimize("kl_divergence")
    theirs["aim_point_final_loss"] = np.float64(jax_aim[0])
    theirs["aim_point_history_total_loss"] = np.asarray(jax_aim[1]["total_loss"])

    # The aim point's first gradient on the scene as one group, under the worker's
    # ground truth, against the JAX loss built from its public functions
    # (``test_torch_aim_point._jax_objective``).
    jax_single, single = _scenes(groups=1)
    single_draw = tuple(
        np.asarray(x) for x in jax_single.light_sources[0].get_distortions(keys[0], points, worker.HELIOSTATS)
    )
    jax_forward, jax_loss = _jax_objective(jax_single, single_draw, worker.aim_point_ground_truth(), "pallas")
    zeros = jnp.zeros((worker.HELIOSTATS, 2))
    flux, intercepts = jax_forward(zeros)
    theirs["aim_point_gradient_0"] = np.asarray(jax.grad(jax_loss)(zeros, (jnp.sum(flux), intercepts), (0.0,) * 3))
    single.light_sources[0] = chip_smoke.FixedDistortions(worker.RAYS, *single_draw)

    # The per-sample losses each median reduction of the port sees: the first two are
    # the raytracing method's first-gradient calls, one a group.
    medians = []
    reduce = losses.reduce_loss_per_heliostat

    def recording(loss_per_sample, indices, valid, reduction="mean"):
        if reduction == "median":
            medians.append(_median_ties(loss_per_sample.detach().numpy()[indices.numpy()], valid.numpy()))
        return reduce(loss_per_sample, indices, valid, reduction)

    with setup_distributed_environment(2, device="cpu") as setup, pytest.MonkeyPatch.context() as patch:
        patch.setattr(losses, "reduce_loss_per_heliostat", recording)
        ours = {}
        for name in ("surface", *METHODS):
            ours.update(worker.run(setup, 2, light_sources={name: queued[name]}, data=data, optimizers=(name,)))
        for g in range(2):
            ours[f"{RAYTRACING}_median_tied_{g}"] = medians[g]
        loss, history, *_ = AimPointOptimizer(scenario=aim_scenario, distributed_setup=setup, **arguments).optimize(
            "kl_divergence"
        )
        ours["aim_point_final_loss"] = np.float64(loss)
        ours["aim_point_history_total_loss"] = np.asarray(history["total_loss"])
    with setup_distributed_environment(1, device="cpu") as setup:
        ours["aim_point_gradient_0"] = worker.aim_point_gradient(
            AimPointOptimizer(scenario=single, distributed_setup=setup, **dict(
                arguments, ground_truth=worker.aim_point_ground_truth()
            ))
        )[0]
    return ours, theirs


# Relative limits on the losses and histories, each about twice the gap measured on
# this scene (surface 6.5e-5, raytracing 5.1e-4, alignment 1.76e-3, aim point
# 1.46e-4); the alignment loss's dots lie ~2.5e-5 below 1, where an fp32 ulp moves
# an angle by 1.2e-3 of itself, so its limit is the single-process tests' 2e-3.
LOSS_RTOL = {"surface": 1e-4, RAYTRACING: 1e-3, ALIGNMENT: 2e-3, "aim_point": 3e-4}
# Limits on the first gradients, as fractions of the largest entry, each about twice
# the gap measured (surface 4.7e-3, raytracing 2.0e-6 off the median's ties,
# alignment 1.1e-3, aim point 5.0e-3). The KL gradients of the surface and the aim
# point weigh pixels that few of the scene's rays reach (4 a point).
GRADIENT_LIMIT = {"surface": 1e-2, RAYTRACING: 1e-5, ALIGNMENT: 2e-3, "aim_point": 1e-2}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_world_of_one_matches_jax(against_jax, optimizer):
    """Losses and histories. Adam moves a parameter by about the rate whatever its
    gradient's size, so entries whose gradients lie within the packages' fp32 noise
    part by up to a step, and the parameters are not compared (as in the
    single-process tests); the first gradients are, below."""
    ours, theirs = against_jax
    keys = [key for key in theirs if key.startswith(optimizer) and ("loss" in key or "history" in key)]
    assert keys
    for key in keys:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=LOSS_RTOL[optimizer], err_msg=key)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_world_of_one_gradient_matches_jax(against_jax, optimizer):
    """The first gradient of each group (the aim point's on the scene as one group).
    The raytracing method reduces a heliostat's samples by their median, which
    hands the gradient of one sample on; where two samples' losses tie within the
    packages' rounding (``_median_ties``) the packages may pick different ones, and
    that heliostat's row is left out. Every group keeps a row."""
    ours, theirs = against_jax
    keys = [key for key in theirs if key.startswith(f"{optimizer}_gradient_")]
    assert len(keys) == (1 if optimizer == "aim_point" else 2)
    for key in keys:
        mine, reference = np.asarray(ours[key]), np.asarray(theirs[key])
        scale = np.abs(reference).max()
        assert scale > 0 and mine.shape == reference.shape, key
        if optimizer == RAYTRACING:
            kept = ~ours[key.replace("gradient", "median_tied")]
            assert kept.any(), key
            mine, reference = mine[kept], reference[kept]
        assert np.abs(mine - reference).max() <= GRADIENT_LIMIT[optimizer] * scale, key


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
