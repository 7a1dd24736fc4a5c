"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``);
exits non-zero without them. It imports only ``torch``, ``numpy`` and the
``artist_tpu_torch`` package beside it, and runs in phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: every ``artist_tpu_torch/kernels/csrc/*.cu`` (with the headers
   beside them), one ``nvcc`` each, all started together;
3. kernels, each against its plain PyTorch version on the card with the
   tolerances stated below, and timed with CUDA events beside its plain
   version, the one-call PyTorch yardstick (where there is one) and the
   card's bound for the same work:
   a. the splat pair at the surface step's chunk inputs (``[100, 40000]``
      rays onto ``[100, 256, 256]``) and on a batch of edge cases, the
      forward also on rays that straddle every band border and on rays piled
      onto a few pixels (``piled_rays``), the backward also on ragged and
      short rays per map and on views at a storage offset
      (``backward_layout_cases``), two launches bit-identical on each, and
      with the kernel's 64-bit indices forced (``backward_gather(wide=True)``)
      on those, the edge cases and the chunk; the backward's timing lines give
      its sector floor beside its bound (``splat_work``);
   b. the blocking sigma pair on the aim-point path's own first-epoch inputs
      (8 M rays, K = 16 candidates), on the same field with its rows 3 m
      apart, where the check must not be vacuous, there with every
      candidate slot kept, at K = 16 and at K = 32, and on edge cases at its
      gates (``gated_edge_cases``); the arbiter is the plain version in
      float64; the four fields are also timed replayed from a CUDA graph, and
      their pairs counted by what makes their sigma exactly 0;
   c. the flat route's kernels on the flat aim-point path's own first-epoch
      inputs (8 M rays against all 100 primitives) and on the same field
      with its rows 3 m apart, timed on both: the AABB cull bit for bit
      against its plain version, there and on a batch of edge cases, and the
      flat sigma pair against the float64 arbiter;
4. surface step: the flagship surface-reconstruction step (100 heliostats,
   50 x 50 points per facet x 4 facets, 32 rays per point = 32 M rays,
   256 x 256 bitmaps, ray chunks of 4) built from the port's public
   functions, one warm-up and three timed ``torch.optim.Adam`` steps on the
   NURBS control points, with the kernels' launch counts asserted;
5. aim point: ``AimPointOptimizer.optimize`` at
   ``bench.py``'s aim-point size (100 heliostats, 50 x 50 points per facet x
   4 facets, 8 rays per point = 8 M rays, field-wide blocking with K = 16),
   one warm-up and three timed epochs, launch counts asserted;
6. blocking step: the surface step of phase 4 with field-wide blocking on;
7. agreement: the small surface step and a small aim-point step on a packed
   dense-row field under a low receiver (at K = 16 and at K = 32, where some
   heliostat keeps more than 16 candidates, and on the flat route), each on
   the card against the same step on the CPU;
8. flat aim point (this slice's main path): phase 5 with
   ``blocking_candidates=None``, field-wide blocking over all 100 primitives
   with the AABB cull, launch counts asserted; then one warm-up and one
   timed epoch of it on the field with its rows 3 m apart, where the cull
   keeps most primitives and some blocking factor must fall below 1;
9. flat blocking step: the blocking step of phase 6 on the flat route;
10. block-window step (this slice's main path): the surface step of phase 4
    with ``splat_block_window=96``, its ray blocks cut point-major over
    10 x 10 point tiles (``bench.py``'s ``BENCH_SPLAT_BLOCK_WINDOW``
    configuration) from the rays in place, its first loss equal to phase 4's,
    and no ray stream reordered in a loss and its backward
    (:func:`ray_stream_reorders`);
11. the splat-formulation tool (``artist_tpu_torch.tools.splat_formulation_bench``)
    at its full shape (32 M rays);
12. surface reconstructor (the North star's main path):
    ``SurfaceReconstructor.reconstruct_surfaces`` at ``bench.py``'s production
    configuration (12 heliostats x 4 synthetic calibration samples, 36 train
    and 12 test; 50 x 50 points per facet x 4 facets, 180 rays per point, 6 x 6
    control points per facet, ray chunks of 12: 64.8 M rays a train epoch, 21.6
    M a validation; cyclic rate, energy constraint, ideal-surface
    regularizer): one warm-up call, then the seconds per epoch as the slope
    between a 2-epoch and a 6-epoch call, each call's launch counts asserted
    and its losses, control points and refreshed surfaces checked; before it,
    the splat pair against its plain versions at the train chunk (``[36,
    120000]`` rays), timed;
13. kinematics reconstructor: ``KinematicsReconstructor.reconstruct_kinematics``
    at the production calibration (examples/field_optimizations/config.yaml:
    56-70; 100 heliostats x 20 samples, 50 x 50 points per facet x 4 facets,
    19 rays per point) on samples built on the card from known rotation
    deviations. a. the alignment method: a warm-up call, then a short and the
    configuration's long call, the seconds per epoch as their slope over the
    epochs run, the loss falling and the deviations nearing the known ones;
    b. the splat pair against its plain versions at the flux-driven method's
    validation and train batches (``[500, 190000]`` and ``[1500, 190000]``
    rays), timed, then the flux-driven method timed the same way and its
    scrubbed gradient; c. a small kinematics loop and a small aim-point loop
    resumed from a checkpoint, against straight runs. Each call's launch counts
    are asserted (:func:`kinematics_launches`).
14. plant scale: a. the plant-scale example
    (``artist_tpu_torch/examples/plant_scale_aim_points.py``) through its entry
    function at its defaults (4,000 heliostats in checkpointed chunks of 500, 2
    rays per point, 50 x 50 points per facet x 4 facets, K = 16: 80 M rays an
    epoch): the field unchunked for 2 epochs, then chunked for 2 and for the
    example's 11 epochs, the seconds per epoch as the slope between the chunked
    calls, rays/s and peak memory; the unchunked histories, intercepts and
    factors held to the chunked ones within the JAX package's tolerances (the
    flux integral's also allowing each run's epoch-0 spread, PLANT_HISTORY_TOLERANCE),
    and the chunked peak below the unchunked one; b. ``bench.py``'s ``xl_field`` step
    (the same field, ray chunks of 1, heliostat chunks of 500) without blocking
    and with blocking at K = 16, 8 and 32, one warm-up and three timed Adam steps
    each, then the chunked step's loss and gradient against the unchunked step's;
    c. the LBVH on the first chunk's first-epoch rays (``[500, 20000]``) against
    all 4,000 primitives, on the synthetic field and with its rows 3 m apart: the
    tree reaches every leaf once, the traversal kernel's keep flags equal its plain
    version's and the cull kernel's bit for bit, both timed, and
    ``soft_ray_blocking_mask(cull_method="lbvh")`` equal to the dense cull's flat
    route bit for bit; d. the splat pair and the sigma pair (K = 16) at that
    chunk's shape against their plain versions, timed, and the sigma pair timed at
    K = 32. Every call's launch counts
    are asserted (:func:`plant_aim_point_launches`, :func:`xl_step_launches`).
15. data ingress: a. three heliostats' STRAL deflectometry files (4 facets of
    80,000 points on a paraboloid with a Gaussian dent of its own each) written
    and read back with ``extract_stral_deflectometry_data``, each fitted on the
    card with ``SurfaceGenerator.generate_fitted_surface_config`` at the
    paint_plots example's configuration (20 x 20 control points, every 100th
    point, the normals, 401 Adam epochs), timed with its epochs and host syncs:
    finite, falling losses and fitted normals near the analytic ones; the first
    also fitted on the CPU and held to the card's fit; b. the fits read by the
    scenario loader's ``_read_heliostats`` from their in-memory scenario image
    (:class:`InMemoryGroup`, no ``h5py``), one group assembled on the card by
    ``_assemble_heliostat_groups`` (``sample_surface`` at 50 x 50 points a
    facet), traced with ``trace_rays`` (1,000 rays a point, 30 M rays, onto
    256 x 256) and against the analytic surfaces at the same grid, launch counts
    asserted (:func:`ingress_launches`); c. the splat forward at that render's
    shape against its plain version, timed.
16. multi-process runs (``artist_tpu_torch.parallel``): the three optimizers at
    the widths of phases 12, 13 (both methods) and 14 (the plant field), a few
    epochs each, on the field as one group and split into two
    (``split_into_groups``): in a world of one without a setup and with an NCCL
    setup, which must agree; then in a world of two gloo ranks spawned on the one
    card (:func:`world_of_two`), group-parallel on the two-group field and nested
    on the one-group field, each held against the world of one (losses,
    parameters, the aim point's factors and each optimizer's first gradient) and
    the ranks against each other, bit for bit. It prints each run's epoch
    seconds, the seconds in collectives, the peak memory of each rank and the
    launches of each rank, asserted against :func:`distributed_launches`.

17. the entry points (``artist_tpu_torch/tutorials``,
    ``artist_tpu_torch/examples/field_optimizations``, the tools): a. tutorials 01-05
    at their own widths and epochs (01: one heliostat, 50 x 50 points a facet, 256 x
    256, held to the same call on the CPU; 02: four heliostats, 25 x 25 points, a
    world of one without a process group; 03: 50 x 50 points, 7 x 7 control points, 50
    epochs; 04: the alignment method, 100 epochs; 05: 40 epochs, K = 16), their
    scenarios parsed from PAINT-format JSON written here and loaded from their images
    in memory, 03 and 04 on calibration samples cast on the card from known rotation
    deviations; b. ``generate_results``'s three stages in sequence on phase 13's field
    at ``config.yaml``'s widths (kinematics: alignment, 20 samples, 19 rays, max_epoch
    500; surfaces: 4 samples, 180 rays, 7 x 7 control points; aim points: 30 rays, K =
    16; the last two cut to max_epoch 10), each stage on the scenario the last one
    left, its files checked for the JAX pipeline's names and keys; c. the kinematics
    stage twice more in the production mode and once under deterministic algorithms,
    their spread; d. ``memory_report`` at the plant configuration, chunked and
    unchunked, and ``ablate_step`` with and without the block window. Every call's
    launches are asserted.
18. the PAINT plot example (``artist_tpu_torch/examples/paint_plots``): a.
    ``reconstruction_generate_results`` at its configuration (the raytracing method,
    max_epoch 1000, lr 1e-4, exponential 0.999, 3 samples a heliostat, 5 x 5 points a
    facet, 10 rays a point) on 2,000 PAINT heliostats written here and loaded by
    ``reconstruction_scenario`` from their image, once on UTIS and once on HeliOS
    centroids cast from known rotation deviations, both losses falling and the UTIS
    run ending below the HeliOS one; the splat pair at its batches (``[4000, 1000]``
    rays onto 4,000 maps) against the plain versions, timed; b.
    ``flux_prediction_raytracing`` on ``flux_prediction_scenario``'s ideal scenario and
    on phase 15's fits, 1,000 rays a point onto 256 x 256 (30 M rays a scenario); c.
    ``flux_prediction_plot``'s demo on the card against the CPU. Every call's launches
    are asserted.

19. the ray kernel pair (``artist_tpu_torch/kernels/rays.py``, ``csrc/rays.cu``): the
    forward and backward kernels against their plain versions at the surface
    reconstruction's chunk (``[36, 12, 10000]``), the flux-driven validation batch
    (``[500, 19, 10000]``) and train batch (``[1500, 19, 10000]``), each with rays on
    and just past every edge of the bitmap, back-facing and grazing rays, the angles
    read in place from a ``[M, R, P, 2]`` sample; two launches bit-equal; both timed
    by events and from a CUDA graph against their byte bounds; then the launches of a
    small checkpointed step, an unchunked one and a render without a gradient. Phase 13
    asserts the pair's launches in every reconstructor call beside the splat's.

Phase 3 also holds the dynamic-window kernels (3d: on the block-window
step's first chunk in place with the tile order, as that step splats it,
without the order, and at 3 rays a point, where blocks straddle points, with a
ragged last block; without an order on rays that force fallback blocks, on the
edge cases, on the piled rays and on rays whose window origin changes at
nearly every block; the kernel's count of blocks that fit their window equal
to the windows of the point-major copy; the backward also on 3a's layout
cases as ``[M, r, P]`` rays in place, and two launches bit-identical on every
case) and the formulation tool's kernels
(3e: the 2-D window's count equal to the plain windows'; the band accumulate
also on rays that straddle every band border); phase 7 also checks a small
block-window step and a small windowed step (7c), and a small surface
reconstructor (3 epochs, its loss histories within phase 7a's loss tolerance)
and a small trace onto a tower with a planar and a cylindrical target area (7d).

Each driven path sets every launch count to 0 just before it and reads them
just after. Then one JSON line of per-kernel numbers and, last, the
``{"ok": true, ...}`` line. Any failure raises and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import artist_tpu_torch  # noqa: E402
from artist_tpu_torch.kernels import splat_scatter, splat_window  # noqa: E402
from artist_tpu_torch.field import heliostat_group as hg  # noqa: E402
from artist_tpu_torch.field.solar_tower import SolarTower, get_centers_of_target_areas  # noqa: E402
from artist_tpu_torch.flux.bitmap import (  # noqa: E402
    crop_flux_distributions_around_center,
    get_center_of_mass,
    trapezoid_distribution,
)
from artist_tpu_torch.geometry.coordinates import (  # noqa: E402
    azimuth_elevation_to_enu,
    bitmap_coordinates_to_target_coordinates,
    convert_3d_directions_to_4d_format,
)
from artist_tpu_torch.examples import plant_scale_aim_points  # noqa: E402
from artist_tpu_torch.examples.field_optimizations import generate_results  # noqa: E402
from artist_tpu_torch.examples.paint_plots import (  # noqa: E402
    flux_prediction_plot,
    flux_prediction_raytracing,
    flux_prediction_scenario,
    reconstruction_generate_results,
    reconstruction_scenario,
)
from artist_tpu_torch.io.calibration import CalibrationData, CalibrationDataParser  # noqa: E402
from artist_tpu_torch.io import paint_scenario_parser  # noqa: E402
from artist_tpu_torch.io.stral import extract_stral_deflectometry_data  # noqa: E402
from artist_tpu_torch.kernels import blocked_rays  # noqa: E402
from artist_tpu_torch.kernels import blocking as blocking_kernels  # noqa: E402
from artist_tpu_torch.kernels import lbvh as lbvh_kernels  # noqa: E402
from artist_tpu_torch.kernels import rays as ray_kernels  # noqa: E402
from artist_tpu_torch.kernels.build import build_all, build_library  # noqa: E402
from artist_tpu_torch.kernels.splat import LAUNCHES as SPLAT_LAUNCHES  # noqa: E402
from artist_tpu_torch.kernels.splat import reset_launch_counts as reset_splat_launch_counts  # noqa: E402
from artist_tpu_torch.kernels.splat import (  # noqa: E402
    backward_gather,
    band_layout,
    shared_limit,
    splat_backward_cuda,
    splat_backward_plain,
    splat_forward_cuda,
    splat_forward_plain,
)
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces  # noqa: E402
from artist_tpu_torch.optim import training  # noqa: E402
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer  # noqa: E402
from artist_tpu_torch.optim.kinematics_reconstructor import VALIDATION_LOSSES, KinematicsReconstructor  # noqa: E402
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor  # noqa: E402
from artist_tpu_torch.parallel import collectives, setup_distributed_environment  # noqa: E402
from artist_tpu_torch.parallel.env import runs_group  # noqa: E402
from artist_tpu_torch.raytracing import geometry, lbvh  # noqa: E402
from artist_tpu_torch.raytracing import blocking as blocking_module  # noqa: E402
from artist_tpu_torch.raytracing.blocking import (  # noqa: E402
    _rectangle as blocking_rectangle,
    candidate_columns,
    create_blocking_primitives_rectangles_by_index,
    primitive_table,
    soft_ray_blocking_mask,
)
from artist_tpu_torch.raytracing.render import (  # noqa: E402
    DEFAULT_MIRROR_REFLECTIVITY,
    RenderConfig,
    point_permutation,
    ray_splat_inputs,
    trace_rays,
)
from artist_tpu_torch.scenario.scenario import (  # noqa: E402
    InMemoryGroup,
    _assemble_heliostat_groups,
    _read_heliostats,
    load_scenario_from_image,
)
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator  # noqa: E402
from artist_tpu_torch.scenario.synthetic import (  # noqa: E402
    SyntheticCalibrationParser,
    make_synthetic_scenario,
    split_into_groups,
)
from artist_tpu_torch.scene.sun import Sun  # noqa: E402
from artist_tpu_torch.tools import (  # noqa: E402
    ablate_step,
    memory_report,
    sass_counts,
    splat_formulation_bench,
)
from artist_tpu_torch.tools.flagship_step import (  # noqa: E402
    BITMAP,
    BLOCK_WINDOW,
    CANDIDATES,
    LEARNING_RATE,
    RAY_CHUNK,
    RAYS,
    SEED,
    SURFACE_POINTS,
    StepInputs,
    aligned_surfaces,
    field_inputs,
    flagship_inputs,
    render,
    step_inputs,
    surface_loss,
)
from artist_tpu_torch.tutorials import (  # noqa: E402
    aim_point_optimization,
    field_raytracing_sharded,
    generate_scenario_from_paint,
    generate_scenario_from_stral,
    kinematics_reconstruction,
    single_heliostat_raytracing,
    surface_reconstruction,
)
from artist_tpu_torch.util import constants  # noqa: E402
from artist_tpu_torch.util.config import (  # noqa: E402
    HeliostatConfig,
    KinematicsConfig,
    PrototypeConfig,
)
from artist_tpu_torch.util.indices import actuator_max_motor_position, actuator_min_motor_position  # noqa: E402
from artist_tpu_torch.util.logging_utils import runtime_log  # noqa: E402

STEPS = 3  # timed, after one warm-up

KERNELS = (
    "splat_forward", "splat_backward", "blocking_sigma_forward", "blocking_sigma_backward",
    "blocking_cull", "blocking_sigma_flat_forward", "blocking_sigma_flat_backward",
    "splat_dynamic_window_forward", "splat_dynamic_window_backward", "splat_window_2d_forward",
    "splat_band_forward", "lbvh_traverse",
)
# The source of each kernel, under artist_tpu_torch/kernels/csrc/.
# The dynamic window's backward launches splat.cu's gather (splat_window.cu's head note).
SOURCES = {
    **dict.fromkeys(("splat_forward", "splat_backward", "splat_band_forward"), "splat.cu"),
    **dict.fromkeys(KERNELS[2:7], "blocking.cu"),
    **dict.fromkeys(("splat_dynamic_window_forward", "splat_window_2d_forward"), "splat_window.cu"),
    "splat_dynamic_window_backward": "splat.cu",
    "lbvh_traverse": "lbvh.cu",
}


def launches(**counts: int) -> dict[str, int]:
    """A launch count for every kernel: the ones named, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


# Per step with RAY_CHUNK = 4: eight chunks, each splat forward run once in
# the forward pass and once more when checkpointing recomputes the chunk in
# the backward pass; one splat backward per chunk. With blocking on, the
# selective checkpoint saves sigma (and the flat route's keep flags), so the
# recompute does not launch the sigma forward (or the cull) again: per chunk
# one sigma forward and one sigma backward, and on the flat route one cull.
CHUNKS = RAYS // RAY_CHUNK
SPLAT_PER_STEP = dict(splat_forward=2 * CHUNKS, splat_backward=CHUNKS)
LAUNCHES_PER_STEP = launches(**SPLAT_PER_STEP)
LAUNCHES_PER_BLOCKING_STEP = launches(
    **SPLAT_PER_STEP, blocking_sigma_forward=CHUNKS, blocking_sigma_backward=CHUNKS
)
LAUNCHES_PER_FLAT_BLOCKING_STEP = launches(
    **SPLAT_PER_STEP, blocking_cull=CHUNKS, blocking_sigma_flat_forward=CHUNKS,
    blocking_sigma_flat_backward=CHUNKS,
)
# The block-window step runs the dynamic-window pair in place of the full splat's.
LAUNCHES_PER_BLOCK_WINDOW_STEP = launches(
    splat_dynamic_window_forward=2 * CHUNKS, splat_dynamic_window_backward=CHUNKS
)

# The aim-point optimizer as bench.py:_bench_aim_point configures it.
AIM_HELIOSTATS = 100
AIM_SURFACE_POINTS = (50, 50)
AIM_RAYS = 8  # 100 x 10,000 points x 8 = 8 M rays per epoch, no ray chunks
AIM_CANDIDATES = CANDIDATES
AIM_EPOCHS = 3  # timed, after one warm-up epoch
DENSE_AIM_EPOCHS = 1  # timed, on the field with its rows 3 m apart (flat route)
AIM_LEARNING_RATE = 1e-3
AIM_GAMMA = 0.99
DNI = 1000.0
# Per epoch: one forward and one backward of each kernel of the route (no ray
# chunks), and on the flat route one cull; per optimize() call, one more
# forward of each (and one more cull) for the epoch-0 references.
AIM_LAUNCHES_PER_EPOCH = {
    AIM_CANDIDATES: launches(
        splat_forward=1, splat_backward=1, blocking_sigma_forward=1, blocking_sigma_backward=1
    ),
    None: launches(
        splat_forward=1, splat_backward=1, blocking_cull=1, blocking_sigma_flat_forward=1,
        blocking_sigma_flat_backward=1,
    ),
}
AIM_LAUNCHES_PER_CALL = {
    AIM_CANDIDATES: launches(splat_forward=1, blocking_sigma_forward=1),
    None: launches(splat_forward=1, blocking_cull=1, blocking_sigma_flat_forward=1),
}

# The surface reconstructor as bench.py:_bench_surface_reconstruction configures
# it (bench.py:585-655, the reference's production campaign): 12 heliostats x 4
# calibration samples (3 train, 1 test each), 50 x 50 points per facet x 4
# facets, 180 rays per point, 6 x 6 control points per facet, ray chunks of 12.
# A train epoch traces 36 x 180 x 10,000 = 64.8 M rays, a validation 21.6 M.
RECON_HELIOSTATS = 12
RECON_SAMPLES = 4
RECON_SURFACE_POINTS = (50, 50)
RECON_RAYS = 180
RECON_CONTROL_POINTS = (6, 6)
RECON_RAY_CHUNK = 12
RECON_EPOCHS = (1, 5)  # max_epoch of the short and the long timed call: 2 and 6 epochs


def reconstruction_configuration(max_epoch: int, lr_min: float = 1e-6, lr_max: float = 1e-4,
                                 step_size_up: int = 122) -> dict:
    """bench.py's optimizer: initial rate 1e-5, tolerance 0, a cyclic rate between
    ``lr_min`` and ``lr_max``, early stopping that never fires, the energy
    constraint (rho 1, tolerance 0.01) and the ideal-surface regularizer (0.10)."""
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-5,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
        },
        constants.scheduler: {
            constants.scheduler_type: constants.cyclic,
            constants.lr_min: lr_min,
            constants.lr_max: lr_max,
            constants.step_size_up: step_size_up,
        },
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.energy_tolerance: 0.01,
            constants.weight_smoothness: 0.0,
            constants.weight_ideal_surface: 0.10,
        },
    }


def reconstruction_launches(max_epoch: int, chunks: int = RECON_RAYS // RECON_RAY_CHUNK) -> dict[str, int]:
    """The launches of one ``reconstruct_surfaces`` call of ``max_epoch + 1`` epochs
    without a stop: per ray chunk, the reference integrals' forward, each train
    epoch's forward, recompute and backward, and the forward of each validation
    (at epochs 0 and ``max_epoch``, as ``log_step`` 0 means ``max_epoch``, and at
    ``max_epoch - 1``)."""
    epochs = max_epoch + 1
    validations = len({0, max_epoch - 1, max_epoch} & set(range(epochs)))
    return launches(
        splat_forward=chunks * (1 + 2 * epochs + validations),
        splat_backward=chunks * epochs,
    )


# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s outside
# the tensor cores (the splat does no matrix work).
PEAK_BYTES_PER_S = 3.35e12
# The card reads device memory in 32-byte sectors (four to an L2 line).
SECTOR_BYTES = 32
PEAK_FP32_FLOP_PER_S = 67e12
# fp32 operations per valid ray (floors and compares not counted):
# forward 2 fractions, 2 complements, 6 products, 4 atomic adds;
# backward 2 fractions, 2 complements, 13 for dw, 6 each for de and du.
FORWARD_FLOPS_PER_RAY = 14
BACKWARD_FLOPS_PER_RAY = 29
# fp32 operations per (ray, kept candidate) pair of the blocking sigma kernels,
# an exponential or a division counted as one operation (the card's SFU and
# division sequences take more instruction slots; the bound stays optimistic):
# forward: six 3-vector dots 30, reciprocal 1, t 2, the two projections 6,
# the two local coordinates 8, the five exponents' arguments 8, five
# exponentials 5, three gate denominators 7, sigma 3, the keep-weighted sum 2;
# backward: the forward's 70 before the sum, then base 2, the three gate
# slopes 11, the projection and t cotangents 12, o.n, d.n, d.u, d.v 6, the six
# ray cotangents 36, the 16 candidate cotangents 41, their sum over rays 16.
SIGMA_FORWARD_OPS_PER_PAIR = 72
SIGMA_BACKWARD_OPS_PER_PAIR = 194
# A flat pair whose gates overflow (sigma exactly 0; kernels.blocking.gates_overflow)
# needs, forward and backward, only the forward's 47 up to the local coordinates,
# the five exponents' arguments 8, two maxima and three comparisons 5.
SIGMA_ZERO_PAIR_OPS = 60
# fp32 operations per (ray, primitive) pair the cull tests: per axis two
# differences, two products, a minimum, a maximum and the running entry and
# exit (24), three comparisons, the own-primitive test and two ANDs.
CULL_OPS_PER_PAIR = 30
# The 67 TFLOP/s peak counts an FMA as two operations; none of the cull's is
# an FMA, so its instructions issue at half that rate at best (128 lanes a
# cycle an SM).
PEAK_FP32_INSTRUCTIONS_PER_S = PEAK_FP32_FLOP_PER_S / 2
# The cull kernel rules a box out for a warp's 128 consecutive rays at once
# (blocking.cu, kCullChunk) with one interval test of the box against the
# rays' bounds: per axis 4 differences and 16 products rounded outwards, 12
# minima and maxima of the products and 2 for the axis's bounds (34), the
# entry and exit bounds 4, three comparisons. A box some ray hits needs one
# exact test. So per-pair tests are no floor for the cull's operations. None
# of these is an FMA either: the bound counts them at the instruction rate.
CULL_BUNDLE_RAYS = 128
CULL_OPS_PER_BUNDLE = 109

# Kernel-vs-plain tolerances, in units of the fp32 rounding unit u = 2^-24.
# Forward: kernel and plain version add the same fp32 deposits (the products
# round identically), each pixel's in an order the atomics choose anew every
# run. A sum of n terms in any order is within (n - 1) u sum|terms| of the
# exact sum, so the two may differ by 2 (n - 1) u sum|terms| per pixel; the
# check takes n and sum|terms| per pixel from the run's own rays.
# Backward: a deterministic gather with the same formulas; nvcc contracts
# a*b + c into one FMA where PyTorch rounds twice, so each gradient may differ
# by a few roundings of its largest term. Allowed: 32 u x max|g| (dw) and
# 32 u x max|g| x max|w| (de, du).
UNIT_ROUNDOFF = 2.0**-24
BACKWARD_TOLERANCE = 32 * UNIT_ROUNDOFF

# The blocking sigma kernels against the plain version in float64 (the
# arbiter), on the same fp32 inputs. At softness 1000 the local coordinate
# u = (o.u + t d.u - c0.u) ... cancels terms of 1e2-1e3 m^2 down to order 1,
# so a few ulps of difference in u move a gate by k du: fp32 arithmetic,
# however correct, is off by up to percents at gate edges, and kernel and fp32
# plain version round differently (FMA contraction, summation order). The
# kernel is therefore held to the fp32 plain version's own error: for sigma,
# the mask and each cotangent (each candidate column separately), the max and
# the mean of |kernel - float64| may be at most ARBITER_FACTOR times those of
# |fp32 plain - float64|, plus a floor. The factor 2 leaves room for two
# independent roundings of the same ill-conditioned elements; the floor,
# 64 ulps of the output's largest magnitude plus 1e-30, covers outputs that
# the fp32 plain version happens to round exactly (an all-zero sigma on an
# unblocked field) and the subnormal tails of the saturated gates.
ARBITER_FACTOR = 2.0
ARBITER_FLOOR_ULPS = 64
ARBITER_FLOOR_ABSOLUTE = 1e-30


STARTED = time.perf_counter()


def _log(message: str, stamp: bool = True) -> None:
    """Prints a line; with ``stamp``, ended by the seconds since the script started."""
    print(f"{message} [{time.perf_counter() - STARTED:.1f} s]" if stamp else message, flush=True)


# The synthetic field puts its rows 12 m apart, and there nothing blocks; with
# rows 3 m apart most heliostats behind the front row are partly blocked.
DENSE_ROW_SPACING = 3.0


def row_positions(
    number_of_heliostats: int,
    row_spacing: float,
    columns: int | None = None,
    column_spacing: float = 8.0,
    first_row: float = 25.0,
) -> np.ndarray:
    """Heliostat positions ``[H, 4]`` of the synthetic field's grid with its rows
    ``row_spacing`` apart (``make_synthetic_scenario`` uses 12 m); by default its
    square grid of columns 8 m apart, the first row 25 m north of the tower."""
    if columns is None:
        columns = max(1, int(np.ceil(np.sqrt(number_of_heliostats))))
    index = np.arange(number_of_heliostats)
    east = (index % columns - (columns - 1) / 2) * column_spacing
    north = (index // columns) * row_spacing + first_row
    ones = np.ones(number_of_heliostats)
    return np.stack([east, north, 1.7 * ones, ones], axis=1).astype(np.float32)


def point_major_copy(x: torch.Tensor, order: torch.Tensor | None) -> torch.Tensor:
    """A ``[M, r, P]`` ray stream as the sequence that cuts the block window's ray blocks,
    ``[M, P * r]``: the points in ``order`` (None: index order), each point's r rays
    together. The layout the JAX package splats; the port's kernels read the stream
    in place, and this copy is the reference for their windows."""
    x = x.transpose(1, 2)
    if order is not None:
        x = x[:, order.long()]
    return x.reshape(x.shape[0], -1).contiguous()


def first_chunk_rays(inputs: StepInputs, point_major: bool = False):
    """The splat's inputs in the main path's first ray chunk: ``[M, chunk * P]`` each,
    ray-major as the splats take them or, with ``point_major``, copied into the
    block-window route's sequence (points outer, in tile order with a layout)."""
    group = inputs.scenario.heliostat_groups[0]
    chunk = inputs.config.ray_chunk
    with torch.no_grad():
        points, normals = aligned_surfaces(group.nurbs_control_points, inputs)
        preferred = geometry.reflect(inputs.incident_ray_directions[:, None, :], normals)
        rays = ray_splat_inputs(
            inputs.scenario.solar_tower,
            preferred,
            points,
            inputs.target_area_indices,
            inputs.distortions_u[:, :chunk],
            inputs.distortions_e[:, :chunk],
            1.0,
            inputs.config,
        )
    e, u, w = rays.bitmap_e, rays.bitmap_u, rays.final_intensities
    if point_major:
        permutation = point_permutation(inputs.config, e.device)
        return tuple(point_major_copy(x, permutation) for x in (e, u, w))
    num = e.shape[0]
    return tuple(x.reshape(num, -1).contiguous() for x in (e, u, w))


def edge_case_rays(width: int, height: int, device: torch.device):
    """Integer, boundary (W-1, H-1), NaN, infinite, negative and zero-weight rays, plus random ones."""
    special = np.array(
        [
            (3.0, 5.0, 1.0),
            (0.0, 0.0, 0.7),
            (width - 2.0, height - 2.0, 1.2),
            (width - 2 + 0.5, height - 2 + 0.25, 0.9),
            (width - 1.0, 7.5, 1.0),
            (7.5, height - 1.0, 1.0),
            (-0.5, 3.5, 1.0),
            (3.5, -1e-3, 1.0),
            (np.nan, 4.5, 1.0),
            (4.5, np.nan, 1.0),
            (np.inf, 4.5, 1.0),
            (-np.inf, 4.5, 1.0),
            (1e30, 4.5, 1.0),
            (6.25, 7.75, 0.0),
            (100.0, 100.0, 0.0),
        ],
        dtype=np.float32,
    )
    rng = np.random.RandomState(SEED)
    num, extra = 3, 2000
    e = rng.uniform(-2, width + 2, (num, extra)).astype(np.float32)
    u = rng.uniform(-2, height + 2, (num, extra)).astype(np.float32)
    w = rng.rand(num, extra).astype(np.float32)
    e, u, w = (
        np.concatenate([np.tile(special[:, k], (num, 1)), x], axis=1)
        for k, x in enumerate((e, u, w))
    )
    return tuple(torch.tensor(x, device=device) for x in (e, u, w))


def event_ms(fn, iterations: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iterations`` back-to-back calls, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations


def graph_ms(fn, iterations: int = 20) -> float:
    """Mean device time of ``fn`` over ``iterations`` calls captured in one CUDA graph and
    replayed: the launches run back to back with no host work between them. Where a
    wrapper's host time is longer than its kernels, event_ms measures the host; this
    measures the device."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iterations):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations


def _valid_taps(e, u, height, width):
    """Strict-bounds mask ``[M, N]`` and the flat bitmap ids of the 4 taps of the valid rays."""
    le, lu = torch.floor(e), torch.floor(u)
    valid = (le >= 0) & (le <= width - 2) & (lu >= 0) & (lu <= height - 2)
    base = torch.where(valid, lu * width + le, torch.zeros_like(e)).long()
    base = base + torch.arange(e.shape[0], device=e.device)[:, None] * (height * width)
    taps = torch.cat([base, base + 1, base + width, base + width + 1], dim=1)
    return valid, taps[valid.repeat(1, 4)]


def _sectors(pixels: torch.Tensor) -> int:
    """The distinct 32-byte sectors that flat fp32 pixel ids fall on, from a 32-byte-aligned base."""
    return int(torch.unique(torch.div(pixels, SECTOR_BYTES // 4, rounding_mode="floor")).numel())


def bound_ms(bytes_moved: float, flops: float, peak_ops_per_s: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / peak_ops_per_s * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def describe_bound(timing: dict) -> str:
    """A timing's bound, and its sector floor where it has one (the splat backward's)."""
    floor = timing.get("sector_floor_ms")
    return f"bound {timing['bound'][0]:.4f} ms ({timing['bound'][1]})" + (
        "" if floor is None else f", sector floor {floor:.4f} ms"
    )


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def check_forward(name: str, kernel: torch.Tensor, plain: torch.Tensor, rays, height: int, width: int):
    """A splat forward kernel's bitmaps against its plain version's, each pixel within
    the rounding bound of two summation orders of its deposits (the tolerance
    note above). Returns (max |kernel - plain|, the worst share of the bound)."""
    _, taps = _valid_taps(rays[0], rays[1], height, width)
    deposits = torch.bincount(taps, minlength=plain.numel()).reshape(plain.shape)
    magnitude = splat_forward_plain(rays[0], rays[1], rays[2].abs(), height, width)
    limit = 2.01 * UNIT_ROUNDOFF * (deposits - 1).clamp(min=0) * magnitude
    difference = (kernel - plain).abs()
    if not bool((difference <= limit).all()):
        worst = int(torch.argmax(difference - limit))
        raise AssertionError(
            f"{name}: pixel {worst} differs by {float(difference.flatten()[worst])} "
            f"> {float(limit.flatten()[worst])} ({int(deposits.flatten()[worst])} deposits)"
        )
    return float(difference.max()), float((difference / limit.clamp(min=1e-38)).max())


def check_backward(name: str, kernel_grads, plain_grads, w: torch.Tensor, cotangent: torch.Tensor):
    """A splat backward kernel's (de, du, dw) against its plain version's, within
    BACKWARD_TOLERANCE. Returns (the three max |kernel - plain|, the worst share)."""
    g_max = float(cotangent.abs().max())
    w_max = float(w.abs().max())
    errors, worst_share = [], 0.0
    for what, k, p, scale in zip(("de", "du", "dw"), kernel_grads, plain_grads, (g_max * w_max, g_max * w_max, g_max)):
        err = _max_abs_err(k, p)
        if not err <= BACKWARD_TOLERANCE * scale:
            raise AssertionError(f"{name} {what}: max |kernel - plain| {err} > {BACKWARD_TOLERANCE * scale}")
        errors.append(err)
        worst_share = max(worst_share, err / (BACKWARD_TOLERANCE * scale))
    return errors, worst_share


def check_edge_gradients(name: str, grads, invalid: list[int], zero_weight: list[int]) -> None:
    """No gradient on rays outside the strict bounds; dw on zero-weight in-bounds rays."""
    de, du, dw = grads
    if not all(bool((x[:, invalid] == 0).all()) for x in (de, du, dw)):
        raise AssertionError(f"{name}: gradient on a ray outside the strict bounds")
    if not bool((dw[:, zero_weight] != 0).all()):
        raise AssertionError(f"{name}: zero-weight in-bounds ray lost its dw")


# The backward's layouts (phases 3a and 3d): ragged N, N below a thread's 4 rays and below
# a warp's 32, and the streams and the cotangent as views at a storage offset that is not
# 16 bytes; in place, each N as [M, r, P]. The kernel takes 4 rays a thread (its dense
# path) where N * 16 >= H * W, else 1: on 256 x 256 maps every case takes the sparse path,
# on 16 x 16 maps N = 17, 1,000 and 1,001 the dense one, on 8 x 2 maps (H x W; 8 rows, so
# that row 4 takes a window of 8) every N the dense one, where at N = 1, 3 and 17 a warp's
# step of 32 rays crosses several maps.
LAYOUT_RAYS = {1: 1, 3: 3, 17: 17, 1000: 4, 1001: 7}  # N: r
LAYOUT_OFFSETS = (0, 1, 3)
MIXED_OFFSETS = (1, 3, 0, 1)  # e, u, w, g: no two streams share their address modulo 16
LAYOUT_BITMAPS = ((256, 256, 7), (16, 16, 7), (2, 8, 256))  # (width, height, maps)


def offset_copy(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` copied into a contiguous view that starts ``offset`` elements into its storage."""
    view = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)[offset:].view(x.shape)
    return view.copy_(x)


def backward_layout_cases(width: int, height: int, maps: int, device: torch.device, in_place: bool = False) -> dict:
    """``{label: (e, u, w, g)}``: ``maps`` maps of N random rays (some out of bounds) for
    each N of LAYOUT_RAYS, each at every offset of LAYOUT_OFFSETS (all four tensors), and
    N = 1001 at MIXED_OFFSETS; with ``in_place``, the rays as ``[M, r, N / r]``."""
    rng = np.random.RandomState(SEED + 40)
    cases = {}
    for n, rays_per_point in LAYOUT_RAYS.items():
        arrays = [rng.uniform(-2, width + 2, (maps, n)), rng.uniform(-2, height + 2, (maps, n)),
                  rng.rand(maps, n), rng.randn(maps, height, width)]
        shape = (maps, rays_per_point, n // rays_per_point) if in_place else (maps, n)
        tensors = [torch.tensor(x.astype(np.float32), device=device) for x in arrays]
        tensors[:3] = [x.reshape(shape) for x in tensors[:3]]
        offsets = {f"offset {k}": (k,) * 4 for k in LAYOUT_OFFSETS}
        if n == max(LAYOUT_RAYS):
            offsets["mixed offsets"] = MIXED_OFFSETS
        for name, each in offsets.items():
            cases[f"N = {n} {list(shape)}, {name}"] = tuple(offset_copy(x, k) for x, k in zip(tensors, each))
    return cases


def check_repeatable(name: str, grads, again) -> None:
    """Two launches of a backward on the same inputs: bit for bit the same outputs."""
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def check_backward_layouts(name: str, kernel, plain, device: torch.device, in_place: bool = False) -> dict:
    """The backward ``kernel(e, u, w, g, height, width)`` against ``plain`` within
    BACKWARD_TOLERANCE on :func:`backward_layout_cases` at each of LAYOUT_BITMAPS, two
    launches bit-identical on each; returns the cases and the worst share of the tolerance."""
    worst, count = 0.0, 0
    for width, height, maps in LAYOUT_BITMAPS:
        cases = backward_layout_cases(width, height, maps, device, in_place)
        for label, (e, u, w, g) in cases.items():
            label = f"{label}, {height} x {width}"
            grads = kernel(e, u, w, g, height, width)
            check_repeatable(f"{name} ({label})", grads, kernel(e, u, w, g, height, width))
            if any(x.shape != e.shape for x in grads):
                raise AssertionError(f"{name} ({label}): gradients of shape {[tuple(x.shape) for x in grads]}")
            _, share = check_backward(f"{name} ({label})", grads, plain(e, u, w, g, height, width), w, g)
            worst = max(worst, share)
        count += len(cases)
    return dict(cases=count, worst_share=worst)


def splat_work(e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int) -> dict:
    """What a splat of these rays must do: the valid rays' taps and deposits (the
    ``index_add_`` yardstick's inputs), and the card's bounds for the forward and the
    backward (each input read once, each output written once, or the operations)."""
    num, rays_per_map = e.shape
    valid, taps = _valid_taps(e, u, height, width)
    num_valid = int(valid.sum())
    weights = torch.where(valid, w, torch.zeros_like(w))
    fe, fu = e - torch.floor(e), u - torch.floor(u)
    values = torch.cat(
        [weights * (1 - fu) * (1 - fe), weights * (1 - fu) * fe, weights * fu * (1 - fe), weights * fu * fe],
        dim=1,
    )[valid.repeat(1, 4)]
    pixels = torch.unique(taps)
    touched = int(pixels.numel())
    sectors = _sectors(pixels)
    rays_total = num * rays_per_map
    # Backward streams: e and u 8 per ray, w 4 per valid ray read; 12 per ray written.
    streams = 8 * rays_total + 4 * num_valid + 12 * rays_total
    return dict(
        taps=taps,
        values=values,
        valid=num_valid,
        touched=touched,
        sectors=sectors,
        # Forward: e and u 8 per ray, w 4 per valid ray read, the maps written.
        forward_bound=bound_ms(8 * rays_total + 4 * num_valid + 4 * num * height * width, FORWARD_FLOPS_PER_RAY * num_valid),
        # Backward: the streams and g 4 per touched pixel read.
        backward_bound=bound_ms(streams + 4 * touched, BACKWARD_FLOPS_PER_RAY * num_valid),
        # The sector floor: the streams and every 32-byte sector of g that a tap falls on, as
        # the card reads g. Not a bound: a pixel's sector neighbours are read whether used or not.
        sector_floor_ms=(streams + SECTOR_BYTES * sectors) / PEAK_BYTES_PER_S * 1e3,
    )


def index_add_ms(work: dict, num: int, height: int, width: int) -> float:
    """The yardstick of a splat forward: one ``index_add_`` of its taps."""
    out = torch.zeros(num * height * width, device=work["values"].device)
    return event_ms(lambda: out.index_add_(0, work["taps"], work["values"]))


def piled_rays(width: int, height: int, device: torch.device):
    """Three heliostats of 40,000 rays piled onto a few pixels, so that the kernels'
    shared-memory atomics collide on every tap: half of each heliostat's rays in one
    2 x 2 cell, the rest within 3 px of it; the first heliostat's cell mid-map, the
    second's on the rows 85-87 (a border of 86-row bands), the third's the last valid one."""
    rng = np.random.RandomState(SEED + 4)
    num, n = 3, 40_000
    corner = np.array([[100.0, 60.0], [30.0, 85.0], [width - 2.0, height - 2.0]])
    spread = np.where(np.arange(n) % 2 == 0, 3.0, 1.0)
    e = corner[:, :1] + np.minimum(spread * rng.rand(num, n), width - 1.0 - corner[:, :1] - 1e-3)
    u = corner[:, 1:] + np.minimum(spread * rng.rand(num, n), height - 1.0 - corner[:, 1:] - 1e-3)
    w = rng.rand(num, n)
    return tuple(torch.tensor(x.astype(np.float32), device=device) for x in (e, u, w))


def time_splat_pair(rays, g: torch.Tensor | None, height: int, width: int,
                    iterations: int = 20) -> tuple[dict[str, dict], dict]:
    """The splat pair on ``rays`` (cotangent ``g``; the forward alone where it is None)
    timed with CUDA events over ``iterations`` launches beside its plain versions and
    the forward's ``index_add_`` yardstick, with the card's bounds; and the work
    (:func:`splat_work`)."""
    e, u, w = rays
    work = splat_work(e, u, w, height, width)
    timings = {
        "splat_forward": dict(
            ms=event_ms(lambda: splat_forward_cuda(e, u, w, height, width), iterations),
            plain_ms=event_ms(lambda: splat_forward_plain(e, u, w, height, width), iterations),
            library_ms=index_add_ms(work, e.shape[0], height, width),
            bound=work["forward_bound"],
        ),
    }
    if g is not None:
        timings["splat_backward"] = dict(
            ms=event_ms(lambda: splat_backward_cuda(e, u, w, g, height, width), iterations),
            plain_ms=event_ms(lambda: splat_backward_plain(e, u, w, g, height, width), iterations),
            library_ms=None,
            bound=work["backward_bound"],
            sector_floor_ms=work["sector_floor_ms"],
        )
    return timings, work


def check_splat_kernels(inputs: StepInputs) -> dict[str, dict]:
    """Phase 3a: each splat kernel against its plain version, then timed. The forward on
    the flagship chunk, the edge cases, the band borders and the piled rays; the backward
    on the first two."""
    width, height = BITMAP
    device = inputs.ground_truth.device
    e, u, w = first_chunk_rays(inputs)
    g = torch.randn(
        (e.shape[0], height, width), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 1),
    )
    edge = edge_case_rays(width, height, device)
    edge_g = torch.randn(
        (edge[0].shape[0], height, width), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 2),
    )
    cases = {
        "flagship chunk": ((e, u, w), g),
        "edge cases": (edge, edge_g),
        "band borders": (band_border_rays(width, height, device), None),
        "piled rays": (piled_rays(width, height, device), None),
    }
    forward_err, backward_errs, worst_share = 0.0, [], 0.0
    for label, (rays, cotangent) in cases.items():
        kernel = splat_forward_cuda(*rays, height, width)
        plain = splat_forward_plain(*rays, height, width)
        err, share = check_forward("splat_forward", kernel, plain, rays, height, width)
        forward_err, worst_share = max(forward_err, err), max(worst_share, share)
        if not torch.isfinite(kernel).all():
            raise AssertionError(f"splat_forward: non-finite bitmap on the {label}")
        if cotangent is None:
            continue
        kernel_grads = splat_backward_cuda(*rays, cotangent, height, width)
        again = splat_backward_cuda(*rays, cotangent, height, width)
        check_repeatable(f"splat_backward ({label})", kernel_grads, again)
        plain_grads = splat_backward_plain(*rays, cotangent, height, width)
        errors, share = check_backward("splat_backward", kernel_grads, plain_grads, rays[2], cotangent)
        backward_errs += errors
        worst_share = max(worst_share, share)
    torch.cuda.synchronize()
    # The edge cases: dw for zero-weight in-bounds rays, nothing from invalid rays.
    check_edge_gradients("splat_backward", splat_backward_cuda(*edge, edge_g, height, width), list(range(4, 13)), [13])
    layouts = check_backward_layouts("splat_backward", splat_backward_cuda, splat_backward_plain, device)
    worst_share = max(worst_share, layouts["worst_share"])
    # The kernel's 64-bit-index instantiation, which no size of the main path reaches,
    # forced: on the edge cases, the layout cases and the chunk, where it must give the
    # int-index launch's bits.
    wide = "splat_backward (64-bit indices)"
    check_edge_gradients(wide, backward_gather(*edge, edge_g, height, width, wide=True), list(range(4, 13)), [13])
    layouts["wide"] = check_backward_layouts(
        wide, lambda *args: backward_gather(*args, wide=True), splat_backward_plain, device
    )
    worst_share = max(worst_share, layouts["wide"]["worst_share"])
    check_repeatable(f"{wide} against int indices at the chunk", backward_gather(e, u, w, g, height, width, wide=True),
                     backward_gather(e, u, w, g, height, width))

    num, rays_per_map = e.shape
    timings, work = time_splat_pair((e, u, w), g, height, width)
    timings["splat_forward"].update(
        max_abs_err=forward_err,
        replaces="artist_tpu/kernels/splat_pallas.py:114 (_splat_fwd_kernel, via _splat_forward)",
    )
    timings["splat_backward"].update(
        max_abs_err=max(backward_errs),
        replaces="artist_tpu/kernels/splat_pallas.py:168 (_splat_bwd_kernel, via _splat_bwd)",
        layouts=layouts,
    )
    _log(
        f"phase 3a splat kernels: [{num}, {rays_per_map}] rays ({work['valid']} valid, {work['touched']} pixels "
        f"touched, {4 * work['valid'] / max(work['touched'], 1):.2f} deposits a touched pixel) -> "
        f"[{num}, {height}, {width}], {edge[0].shape[1]} edge-case rays x {edge[0].shape[0]}, the band borders and "
        f"the piled rays, the backward also on {layouts['cases']} layouts (N = "
        f"{', '.join(map(str, LAYOUT_RAYS))}; views at offsets {LAYOUT_OFFSETS} and {MIXED_OFFSETS}; maps of "
        f"{', '.join(f'{m} of {h} x {w}' for w, h, m in LAYOUT_BITMAPS)}), two launches bit-identical on each, "
        f"and with 64-bit indices forced on those, the edge cases and the chunk (there the int-index launch's bits); the "
        f"forward's {-(-height // band_layout(height, width, shared_limit(device)))} bands a "
        f"map send no global atomic and store {4 * num * height * width} bytes, against the 4 x valid = "
        f"{4 * work['valid']} scalar atomics of a ray a thread; worst error {worst_share:.3g} of its tolerance: "
        + "; ".join(
            f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} ms, "
            + describe_bound(t)
            for name, t in timings.items()
        )
    )
    return timings


# --------------------------------------------------------------------------- #
# The dynamic-window kernels (phase 3d) and the formulation tool's (phase 3e).
# --------------------------------------------------------------------------- #


def mixed_window_rays(width: int, height: int, device: torch.device):
    """Three heliostats of 4,000 rays in four blocks of 1,024: rows ~30-38 (the block
    fits a 96-row window), rows spread over the bitmap (it falls back), rows
    ~120-130 (fits), and a ragged last block over the last 56 rows (fits at the
    origin clamped to H - 96); some rows and columns out of bounds."""
    rng = np.random.RandomState(SEED)
    num, n = 3, 4000
    u = np.concatenate(
        [
            30 + 8 * rng.rand(num, 1024),
            5 + (height - 56) * rng.rand(num, 1024),
            120 + 10 * rng.rand(num, 1024),
            height - 56 + 50 * rng.rand(num, n - 3072),
        ],
        axis=1,
    )
    e = (width - 6) * rng.rand(num, n)
    u[:, :17] = -5.0
    e[:, 40:50] = width + 44.0
    w = rng.rand(num, n)
    return tuple(torch.tensor(x.astype(np.float32), device=device) for x in (e, u, w))


# In window_edge_rays, the copies of edge_case_rays's invalid rays (its 4-12)
# and zero-weight in-bounds rays (13-14) at the head of the second block.
WINDOW_EDGE_INVALID = list(range(1024, 1033))
WINDOW_EDGE_ZERO_WEIGHT = [1033, 1034]


def window_edge_rays(width: int, height: int, device: torch.device):
    """The edge cases of :func:`edge_case_rays` (their block of 1,024 rays falls back)
    and a second block that fits the 96-row window at the clamped origin
    H - 96 with its deposits reaching the last row, holding copies of the
    invalid (NaN, +-inf, 1e30, out of bounds) and zero-weight rays."""
    e, u, w = (x.clone() for x in edge_case_rays(width, height, device))
    n = u.shape[1] - 1024
    u[:, 1024:] = torch.linspace(height - 96.0, height - 2.0, n, device=device)
    for x in (e, u, w):
        x[:, 1024:1035] = x[:, 4:15]
    u[:, WINDOW_EDGE_ZERO_WEIGHT] = height - 55.75
    return e, u, w


def origin_change_rays(width: int, height: int, device: torch.device):
    """Sixteen heliostats of 40 blocks of 1,024 rays whose 96-row windows change origin from
    one fitting block to the next (rows ~10-40 and ~130-160 by turns), with four
    blocks at one origin (~50-80), a block that falls back between two with the same
    origin and a block without a valid ray between two others."""
    rng = np.random.RandomState(SEED + 5)
    num, blocks, block = 16, 40, 1024
    base = np.where(np.arange(blocks) % 2 == 0, 10.0, 130.0)
    base[10:14] = 50.0
    u = base[None, :, None] + 30 * rng.rand(num, blocks, block)
    e = 5 + (width - 10) * rng.rand(num, blocks, block)
    u[:, 21] = 5 + (height - 10) * rng.rand(num, block)  # falls back between blocks 20 and 22 (rows ~10-40)
    u[:, 31] = -3.0  # no valid ray, between blocks 30 and 32
    w = rng.rand(num, blocks, block)
    return tuple(torch.tensor(x.reshape(num, -1).astype(np.float32), device=device) for x in (e, u, w))


def check_dynamic_window_kernels(inputs: StepInputs) -> dict[str, dict]:
    """Phase 3d: the dynamic-window pair on the block-window step's first chunk as that step
    splats it (the ``[M, 4, P]`` streams in place with the tile order), on the same
    streams without the order, on their first 3 rays a point (r = 3, so that blocks
    straddle points, and a ragged last block) with the order, and with no order on rays
    that force fallback blocks, on the edge cases, on the piled rays and on rays whose
    window origin changes at nearly every block, each against its plain version; the
    forward kernel's count of fitting blocks equal to the windows of the point-major copy
    (:func:`point_major_copy`, :func:`splat_window.dyn_offsets`), above half the blocks on
    the chunk, fallbacks present on the forced input, the edge cases and the origin
    changes; and on the chunk with an order whose entries leave [0, P), which must fault
    nothing and leave the bitmap the full splat's. Timed on the chunk beside the full
    splat's kernels on the same rays."""
    width, height = BITMAP
    window = BLOCK_WINDOW["splat_block_window"]
    device = inputs.ground_truth.device
    config = dataclasses.replace(inputs.config, **BLOCK_WINDOW)
    chunk_rays = first_chunk_rays(dataclasses.replace(inputs, config=config))
    num, rays_per_map = chunk_rays[0].shape
    chunk = tuple(x.reshape(num, config.ray_chunk, -1) for x in chunk_rays)
    order = point_permutation(config, device)
    cases = {
        "flagship chunk": (chunk, order),
        "flagship chunk, no order": (chunk, None),
        "3 rays a point": (tuple(x[:, :3].contiguous() for x in chunk), order),
        "forced fallbacks": (mixed_window_rays(width, height, device), None),
        "edge cases": (window_edge_rays(width, height, device), None),
        "piled rays": (piled_rays(width, height, device), None),
        "origin changes": (origin_change_rays(width, height, device), None),
    }
    forward_err, backward_errs, worst_share, fitting = 0.0, [], 0.0, {}
    for seed, (label, (rays, point_order)) in enumerate(cases.items()):
        g = torch.randn(
            (rays[0].shape[0], height, width), device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + 10 + seed),
        )
        kernel, count = splat_window.splat_dynamic_window_forward_cuda(*rays, height, width, window, None, point_order)
        plain = splat_window.splat_dynamic_window_forward_plain(*rays, height, width, window, None, point_order)
        sequence = rays if rays[0].dim() == 2 else tuple(point_major_copy(x, point_order) for x in rays)
        _, fits = splat_window.dyn_offsets(sequence[0], sequence[1], height, width, window)
        fitting[label] = (int(count.sum()), int(fits.sum()), fits.numel())
        if fitting[label][0] != fitting[label][1]:
            raise AssertionError(f"{label}: {fitting[label][0]} blocks fit in the kernel, {fitting[label][1]} in the plain windows")
        flat = tuple(x.reshape(x.shape[0], -1) for x in rays)
        err, share = check_forward("splat_dynamic_window_forward", kernel, plain, flat, height, width)
        forward_err, worst_share = max(forward_err, err), max(worst_share, share)
        grads = splat_window.splat_dynamic_window_backward_cuda(*rays, g, height, width, window, None, point_order)
        again = splat_window.splat_dynamic_window_backward_cuda(*rays, g, height, width, window, None, point_order)
        check_repeatable(f"splat_dynamic_window_backward ({label})", grads, again)
        plain_grads = splat_window.splat_dynamic_window_backward_plain(*rays, g, height, width, window, None, point_order)
        errors, share = check_backward("splat_dynamic_window_backward", grads, plain_grads, rays[2], g)
        backward_errs += errors
        worst_share = max(worst_share, share)
        if label == "edge cases":
            if not torch.isfinite(kernel).all():
                raise AssertionError("splat_dynamic_window_forward: non-finite bitmap from NaN/inf rays")
            for invalid, zero_weight in ((list(range(4, 13)), [13]), (WINDOW_EDGE_INVALID, WINDOW_EDGE_ZERO_WEIGHT)):
                check_edge_gradients("splat_dynamic_window_backward", grads, invalid, zero_weight)
        del plain, plain_grads, sequence, again
    layouts = check_backward_layouts(
        "splat_dynamic_window_backward",
        lambda e, u, w, g, h, wd: splat_window.splat_dynamic_window_backward_cuda(e, u, w, g, h, wd, min(window, h)),
        lambda e, u, w, g, h, wd: splat_window.splat_dynamic_window_backward_plain(e, u, w, g, h, wd, min(window, h)),
        device, in_place=True,
    )
    worst_share = max(worst_share, layouts["worst_share"])
    # An order entry outside [0, P) leaves its point's rays out of the plan, not the bitmap.
    bad_order = order.clone()
    bad_order[::7], bad_order[3::7] = order.numel() + 5, -2
    kernel, _ = splat_window.splat_dynamic_window_forward_cuda(*chunk, height, width, window, None, bad_order)
    check_forward("splat_dynamic_window_forward", kernel, splat_forward_plain(*chunk_rays, height, width),
                  chunk_rays, height, width)
    torch.cuda.synchronize()
    ok = (
        fitting["flagship chunk"][0] > fitting["flagship chunk"][2] / 2
        and fitting["3 rays a point"][0] > fitting["3 rays a point"][2] / 2
        and 0 < fitting["forced fallbacks"][0] < fitting["forced fallbacks"][2]
        and 0 < fitting["edge cases"][0] < fitting["edge cases"][2]
        and 0 < fitting["origin changes"][0] < fitting["origin changes"][2]
    )
    if not ok:
        raise AssertionError(f"dynamic window: the check is vacuous (fitting, plain, blocks: {fitting})")

    e, u, w = chunk
    flat_e, flat_u, flat_w = chunk_rays
    g = torch.randn((num, height, width), device=device, generator=torch.Generator(device=device).manual_seed(SEED + 1))
    work = splat_work(flat_e, flat_u, flat_w, height, width)
    fit_fraction = fitting["flagship chunk"][0] / fitting["flagship chunk"][2]

    def forward():
        return splat_window.splat_dynamic_window_forward_cuda(e, u, w, height, width, window, None, order)

    def backward():
        return splat_window.splat_dynamic_window_backward_cuda(e, u, w, g, height, width, window, None, order)

    timings = {
        "splat_dynamic_window_forward": dict(
            ms=event_ms(forward),
            graph_ms=graph_ms(forward),
            plain_ms=event_ms(
                lambda: splat_window.splat_dynamic_window_forward_plain(e, u, w, height, width, window, None, order), 3, 1
            ),
            library_ms=index_add_ms(work, num, height, width),
            full_splat_ms=event_ms(lambda: splat_forward_cuda(flat_e, flat_u, flat_w, height, width)),
            bound=work["forward_bound"],
            max_abs_err=forward_err,
            fit_fraction=fit_fraction,
            replaces="artist_tpu/kernels/splat_pallas.py:393 (_dyn_fwd_kernel, pallas_call :658)",
        ),
        "splat_dynamic_window_backward": dict(
            ms=event_ms(backward),
            graph_ms=graph_ms(backward),
            plain_ms=event_ms(
                lambda: splat_window.splat_dynamic_window_backward_plain(e, u, w, g, height, width, window, None, order),
                3, 1,
            ),
            library_ms=None,
            full_splat_ms=event_ms(lambda: splat_backward_cuda(flat_e, flat_u, flat_w, g, height, width)),
            bound=work["backward_bound"],
            sector_floor_ms=work["sector_floor_ms"],
            max_abs_err=max(backward_errs),
            fit_fraction=fit_fraction,
            layouts=layouts,
            replaces="artist_tpu/kernels/splat_pallas.py:460 (_dyn_bwd_kernel, pallas_call :706)",
        ),
    }
    _log(
        f"phase 3d dynamic-window kernels (window {window}): [{num}, {config.ray_chunk}, {rays_per_map // config.ray_chunk}] "
        f"rays of the block-window step's first chunk in place ({work['valid']} valid, {work['touched']} pixels "
        f"touched), with and without the tile order, its first 3 rays a point, the forced fallbacks, the edge cases, "
        f"the piled rays and the origin changes; blocks fitting (kernel, plain windows of the point-major copy, of): "
        + ", ".join(f"{label} {f}" for label, f in fitting.items())
        + f"; the forward's {-(-height // splat_window.window_band_rows(rays_per_map, height, width, shared_limit(device)))} "
        f"bands a map send no global atomic and store {4 * num * height * width} bytes on the chunk, against the "
        f"4 x valid = {4 * work['valid']} scalar atomics of a ray a thread; the backward is the full splat's kernel, "
        f"also on {layouts['cases']} layouts in place ([M, r, P] of N = {', '.join(map(str, LAYOUT_RAYS))}; views at "
        f"offsets {LAYOUT_OFFSETS} and {MIXED_OFFSETS}; maps of {', '.join(f'{m} of {h} x {w}' for w, h, m in LAYOUT_BITMAPS)}"
        "), two launches bit-identical on each case"
        + f"; worst error {worst_share:.3g} of its tolerance: "
        + "; ".join(
            f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} replayed), "
            f"full splat's kernel {t['full_splat_ms']:.4f} ms on the same rays, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} ms, "
            + describe_bound(t)
            for name, t in timings.items()
        )
    )
    return timings


def band_border_rays(width: int, height: int, device: torch.device):
    """Three heliostats of 8 rays on every row: ray j of row r has u = r + (j + 0.5) / 8 and
    e anywhere in the map, so for any cut of the map into bands of rows, rays on
    the border rows put their upper taps in one band and their lower taps in
    the next."""
    rng = np.random.RandomState(SEED + 3)
    num, per_row = 3, 8
    u = np.arange(height - 1)[:, None] + (np.arange(per_row) + 0.5) / per_row
    u = np.tile(u.reshape(1, -1), (num, 1))
    e = rng.uniform(0, width - 1, u.shape)
    w = rng.rand(*u.shape)
    return tuple(torch.tensor(x.astype(np.float32), device=device) for x in (e, u, w))


def check_formulation_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 3e: the formulation tool's kernels, the 2-D window forward (the band kernel
    planning rows and columns) and the per-ray band accumulate, against their plain
    versions on the tool's own rays (its full shape, 32 M rays), on the edge cases and
    (the band accumulate only) on rays that straddle every band border; the 2-D
    kernel's count of fitting blocks equal to the plain windows'
    (:func:`splat_window.window_2d_offsets`), some blocks fitting on the tool's rays
    and some falling back on the edge cases. Timed on the tool's rays, by events and
    replayed from a CUDA graph."""
    width, height = BITMAP
    cases = {
        "tool rays": splat_formulation_bench.flagship_rays(device=device),
        "edge cases": window_edge_rays(width, height, device),
    }
    errors, worst_share, fitting = {"splat_window_2d_forward": 0.0, "splat_band_forward": 0.0}, 0.0, {}
    for label, rays in cases.items():
        kernel, count = splat_window.splat_window_2d_forward_cuda(*rays, height, width)
        plain = splat_window.splat_window_2d_forward_plain(*rays, height, width)
        _, _, fits = splat_window.window_2d_offsets(rays[0], rays[1], height, width)
        fitting[label] = (int(count.sum()), int(fits.sum()), fits.numel())
        if fitting[label][0] != fitting[label][1]:
            raise AssertionError(f"{label}: {fitting[label][0]} blocks fit in the 2-D kernel, {fitting[label][1]} in the plain windows")
        err, share = check_forward("splat_window_2d_forward", kernel, plain, rays, height, width)
        errors["splat_window_2d_forward"], worst_share = max(errors["splat_window_2d_forward"], err), max(worst_share, share)
        del kernel, plain
        kernel = splat_scatter.splat_band_forward_cuda(*rays, height, width)
        plain = splat_forward_plain(*rays, height, width)
        err, share = check_forward("splat_band_forward", kernel, plain, rays, height, width)
        errors["splat_band_forward"], worst_share = max(errors["splat_band_forward"], err), max(worst_share, share)
        if not torch.isfinite(kernel).all():
            raise AssertionError(f"{label}: non-finite bitmap from the band accumulate")
        del kernel, plain
    border = band_border_rays(width, height, device)
    err, share = check_forward("splat_band_forward", splat_scatter.splat_band_forward_cuda(*border, height, width),
                               splat_forward_plain(*border, height, width), border, height, width)
    errors["splat_band_forward"], worst_share = max(errors["splat_band_forward"], err), max(worst_share, share)
    torch.cuda.synchronize()
    if not (fitting["tool rays"][0] > 0 and fitting["edge cases"][0] < fitting["edge cases"][2]):
        raise AssertionError(f"2-D window: the check is vacuous (fitting, plain, blocks: {fitting})")

    e, u, w = cases["tool rays"]
    del cases
    num, rays_per_map = e.shape
    work = splat_work(e, u, w, height, width)
    library = index_add_ms(work, num, height, width)
    def window_2d():
        return splat_window.splat_window_2d_forward_cuda(e, u, w, height, width)

    def band():
        return splat_scatter.splat_band_forward_cuda(e, u, w, height, width)

    timings = {
        "splat_window_2d_forward": dict(
            ms=event_ms(window_2d),
            graph_ms=graph_ms(window_2d),
            plain_ms=event_ms(lambda: splat_window.splat_window_2d_forward_plain(e, u, w, height, width), 3, 1),
            fit_fraction=fitting["tool rays"][0] / fitting["tool rays"][2],
            replaces="tools/splat_formulation_bench.py:174 (_dyn2d_fwd_kernel, pallas_call :307)",
        ),
        "splat_band_forward": dict(
            ms=event_ms(band),
            graph_ms=graph_ms(band),
            plain_ms=event_ms(lambda: splat_forward_plain(e, u, w, height, width), 3, 1),
            replaces="tools/splat_formulation_bench.py:321 (_scatter_kernel, pallas_call :360)",
        ),
    }
    for name, t in timings.items():
        t.update(library_ms=library, bound=work["forward_bound"], max_abs_err=errors[name])
    _log(
        f"phase 3e formulation kernels: the tool's [{num}, {rays_per_map}] rays ({work['valid']} valid, "
        f"{work['touched']} pixels touched), the edge cases and the band borders; 2-D blocks fitting (kernel, "
        "plain, of): "
        + ", ".join(f"{label} {f}" for label, f in fitting.items())
        + f"; worst error {worst_share:.3g} of its tolerance: "
        + "; ".join(
            f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} replayed) "
            "against index_add_'s "
            f"{t['library_ms']:.4f} ms in this run, plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]})"
            for name, t in timings.items()
        )
    )
    return timings


# What reads a ray stream out of its order: point_major_copy's indexing, or the
# index_select of a point-major reorder (whose backward is an index_add_).
REORDER_OPS = (
    torch.ops.aten.index_select.default, torch.ops.aten.index.Tensor, torch.ops.aten.gather.default,
    torch.ops.aten.take.default,
)


class CountRayStreamReorders(TorchDispatchMode):
    """Counts the calls of ``REORDER_OPS`` that read a ray stream (``rays`` elements, in any
    view) through an index with an entry for each point or each ray (``points`` or ``rays``
    of them): a reorder of the stream. A gather of heliostats (an index of M) is none."""

    def __init__(self, rays: int, points: int):
        super().__init__()
        self.rays, self.points = rays, points
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in REORDER_OPS and isinstance(args[0], torch.Tensor) and args[0].numel() == self.rays:
            indices = [x for x in torch.utils._pytree.tree_leaves(args[1:]) if isinstance(x, torch.Tensor)]
            self.count += any(x.numel() in (self.points, self.rays) for x in indices)
        return func(*args, **(kwargs or {}))


def ray_stream_reorders(inputs: StepInputs) -> int:
    """Phase 10's count: the calls that reorder a ray stream of a chunk (``[M, chunk, P]``;
    :class:`CountRayStreamReorders`) in one loss and backward of the step."""
    group = inputs.scenario.heliostat_groups[0]
    num, rays, points = inputs.distortions_u.shape
    control_points = group.nurbs_control_points.clone().requires_grad_(True)
    with CountRayStreamReorders(num * (inputs.config.ray_chunk or rays) * points, points) as mode:
        surface_loss(control_points, inputs).backward()
    return mode.count


def reset_launch_counts() -> None:
    reset_splat_launch_counts()
    blocking_kernels.reset_launch_counts()
    splat_window.reset_launch_counts()
    splat_scatter.reset_launch_counts()
    lbvh_kernels.reset_launch_counts()
    ray_kernels.reset_launch_counts()
    blocked_rays.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {**SPLAT_LAUNCHES, **blocking_kernels.LAUNCHES, **splat_window.LAUNCHES, **splat_scatter.LAUNCHES,
            **lbvh_kernels.LAUNCHES}


def drive_surface_step(inputs: StepInputs, launches_per_step: dict[str, int], phase: str) -> dict:
    """One warm-up and STEPS timed Adam steps of the flagship surface step."""
    group = inputs.scenario.heliostat_groups[0]
    device = group.positions.device
    control_points = group.nurbs_control_points.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([control_points], lr=LEARNING_RATE)
    synchronize(device)
    reset_peak_memory(device)
    reset_launch_counts()
    step_seconds, losses = [], []
    for step in range(1 + STEPS):
        start = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss = surface_loss(control_points, inputs)
        loss.backward()
        grad = control_points.grad.detach().clone()
        optimizer.step()
        synchronize(device)
        if step:
            step_seconds.append(time.perf_counter() - start)
        losses.append(loss.item())
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{phase}, step {step}: loss {losses[-1]} is not finite")
        if not torch.isfinite(grad).all() or not (grad != 0).any():
            raise AssertionError(f"{phase}, step {step}: control-point gradient not finite or all zero")
    launches = launch_counts()
    expected = {name: count * (1 + STEPS) for name, count in launches_per_step.items()}
    if device.type == "cuda" and launches != expected:
        raise AssertionError(f"{phase} launched {launches}, expected {expected}")
    rays = inputs.distortions_u.numel()
    mean_step = sum(step_seconds) / len(step_seconds)
    result = dict(
        launches=launches,
        step_seconds=step_seconds,
        rays_per_step=rays,
        rays_per_second=rays / mean_step,
        max_memory_allocated=max_memory(device),
        losses=losses,
    )
    _log(
        f"{phase}: {1 + STEPS} Adam steps (1 warm-up) of {rays} rays, "
        f"losses {losses}, step seconds {step_seconds} (mean {mean_step:.6f}), "
        f"{result['rays_per_second']:.6g} rays/s, max_memory_allocated "
        f"{result['max_memory_allocated']} B, launches {launches}"
    )
    return result


# --------------------------------------------------------------------------- #
# The aim-point path.
# --------------------------------------------------------------------------- #


class FixedDistortions:
    """A light source that hands out given sun distortions (numpy ``[H, R, P]``
    pairs) on the generator's device, so two runs can share them."""

    def __init__(self, number_of_rays: int, distortions_u: np.ndarray, distortions_e: np.ndarray):
        self.number_of_rays = number_of_rays
        self.distortions = (distortions_u, distortions_e)

    def get_distortions(self, generator, number_of_points: int, number_of_active_heliostats: int):
        return tuple(torch.tensor(x, device=generator.device) for x in self.distortions)


class QueuedDistortions:
    """A light source that hands out given sun distortions, one numpy ``[M, R, P]``
    pair a call in the order given, on the generator's device: the surface
    reconstructor draws its train batch's and then its test batch's."""

    def __init__(self, number_of_rays: int, pairs):
        self.number_of_rays = number_of_rays
        self.pairs = list(pairs)

    def get_distortions(self, generator, number_of_points: int, number_of_active_heliostats: int):
        distortions_u, distortions_e = self.pairs.pop(0)
        if distortions_u.shape != (number_of_active_heliostats, self.number_of_rays, number_of_points):
            raise ValueError(f"queued distortions {distortions_u.shape} do not fit the draw")
        return tuple(torch.tensor(x, device=generator.device) for x in (distortions_u, distortions_e))


def aim_point_scenario(
    device,
    heliostats: int,
    surface_points,
    rays: int,
    row_spacing: float | None = None,
    receiver_height: float | None = None,
    **layout,
):
    """The synthetic field of the aim-point path, its rows ``row_spacing`` apart if
    given (``layout``: the other arguments of :func:`row_positions`), and its
    receiver's centre ``receiver_height`` m up if given (45 m otherwise)."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=heliostats,
        number_of_surface_points_per_facet=surface_points,
        number_of_rays=rays,
        device=device,
    )
    if row_spacing is not None:
        group = scenario.heliostat_groups[0]
        positions = torch.tensor(row_positions(heliostats, row_spacing, **layout), device=device)
        scenario.heliostat_groups[0] = group.replace(positions=positions)
    if receiver_height is not None:
        tower = scenario.solar_tower
        centers = tower.planar_centers.clone()
        centers[:, 2] = receiver_height
        scenario.solar_tower = dataclasses.replace(tower, planar_centers=centers)
    return scenario


def aim_point_ground_truth(bitmap: tuple[int, int], device, slope: int = 30, plateau: int = 60) -> torch.Tensor:
    """``outer(trapezoid(height), trapezoid(width))``, as bench.py's aim-point entry."""
    vertical = trapezoid_distribution(bitmap[1], slope, plateau, device=device)
    horizontal = trapezoid_distribution(bitmap[0], slope, plateau, device=device)
    return torch.outer(vertical, horizontal)


def aim_point_optimizer(
    scenario, ground_truth, max_epoch: int, candidates: int, bitmap, **options
) -> AimPointOptimizer:
    """``bench.py:_bench_aim_point``'s optimizer: lr 1e-3, exponential decay 0.99,
    all three penalty weights 1, maximum flux density 1e6, incident light
    ``[0, 1, 0, 0]`` onto target 0 at a DNI of 1000; ``options`` go to the
    constructor."""
    configuration = {
        constants.optimization: {
            constants.initial_learning_rate: AIM_LEARNING_RATE,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.batch_size: 96,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
        },
        constants.scheduler: {constants.scheduler_type: constants.exponential, constants.gamma: AIM_GAMMA},
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.rho_intercept: 1.0,
            constants.rho_local_flux: 1.0,
            constants.max_flux_density: 1e6,
        },
    }
    return AimPointOptimizer(
        scenario=scenario,
        optimization_configuration=configuration,
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        target_area_index=0,
        ground_truth=ground_truth.cpu().numpy(),
        dni=DNI,
        bitmap_resolution=bitmap,
        seed=SEED,
        blocking_candidates=candidates,
        **options,
    )


# The blocking operators whose inputs the kernel phases take from the path, and
# how many of their arguments are tensors.
CAPTURED_OPS = {"blocking_sigma": 5, "blocking_sigma_flat": 4, "blocking_cull": 5}


class CaptureBlockingInputs(TorchDispatchMode):
    """Records the arguments of every blocking operator call it sees, by operator name."""

    def __init__(self):
        super().__init__()
        self.calls = {name: [] for name in CAPTURED_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for name in CAPTURED_OPS:
            if func is getattr(torch.ops.artist_tpu_torch, name).default:
                self.calls[name].append(args)
        return func(*args, **(kwargs or {}))


def first_epoch(optimizer: AimPointOptimizer):
    """``optimizer.objective()`` and its epoch-0 forward without gradient.

    Returns ``params``, ``loss_fn``, the forward's outputs (the target's flux,
    intercepts, on-target and blocking factors) and the blocking operators'
    own inputs in that forward, ``{name: (tensors, parameters)}`` for each
    operator it called once (the compacted route's ``blocking_sigma``, or
    the flat route's ``blocking_cull`` and ``blocking_sigma_flat``).
    """
    params, forward, loss_fn = optimizer.objective("kl_divergence")
    capture = CaptureBlockingInputs()
    with torch.no_grad(), capture:
        outputs = forward(params)
    captured = {}
    for name, calls in capture.calls.items():
        if len(calls) > 1:
            raise AssertionError(f"the epoch-0 forward called {name} {len(calls)} times")
        if calls:
            tensors = CAPTURED_OPS[name]
            captured[name] = (tuple(calls[0][:tensors]), tuple(calls[0][tensors:]))
    return params, loss_fn, outputs, captured


def _per_heliostat(fn, tensors, parameters, dtype, chunk: int = 10):
    """``fn`` over slices of the heliostat axis (float64 would not fit whole)."""
    parts = []
    for start in range(0, tensors[0].shape[0], chunk):
        parts.append(fn(*(x[start : start + chunk].to(dtype) for x in tensors), *parameters))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(pieces) for pieces in zip(*parts))


def _arbitrate(what: str, kernel: torch.Tensor, plain: torch.Tensor, reference: torch.Tensor) -> float:
    """Hold the kernel to ARBITER_FACTOR x the fp32 plain version's error against
    float64, in max and in mean, plus the floor; returns the worst share of a limit.
    Where the float64 reference is NaN (a NaN or infinite input), the kernel must be
    NaN too, and nowhere else; the other entries are held to the limits."""
    nan = reference.isnan()
    if not torch.equal(kernel.isnan(), nan):
        raise AssertionError(f"{what}: NaN in {int((kernel.isnan() != nan).sum())} entries where the float64 "
                             "reference is not, or a number where it is NaN")
    if nan.any():
        kernel, plain, reference = kernel[~nan], plain[~nan], reference[~nan]
        if reference.numel() == 0:
            return 0.0
    kernel, plain = kernel.double(), plain.double()
    floor = ARBITER_FLOOR_ULPS * UNIT_ROUNDOFF * float(reference.abs().max()) + ARBITER_FLOOR_ABSOLUTE
    error_kernel, error_plain = (kernel - reference).abs(), (plain - reference).abs()
    worst = 0.0
    for statistic in ("max", "mean"):
        k = float(getattr(error_kernel, statistic)())
        limit = ARBITER_FACTOR * float(getattr(error_plain, statistic)()) + floor
        if not k <= limit:
            raise AssertionError(f"{what}: {statistic} |kernel - float64| {k} > {limit}")
        worst = max(worst, k / limit)
    return worst


def check_sigma_pair(label: str, inputs, parameters, gbar, alpha: float = 100.0) -> dict:
    """The sigma kernels against the plain version, fp32 and float64, on ``inputs``;
    the mask ``1 - exp(-alpha sigma)`` with the render's Beer-Lambert factor."""
    sigma = blocking_kernels.sigma_forward_cuda(*inputs, *parameters)
    grads = blocking_kernels.sigma_backward_cuda(*inputs, gbar, *parameters)
    torch.cuda.synchronize()
    plain = _per_heliostat(blocking_kernels.sigma_forward_plain, inputs, parameters, torch.float32)
    reference = _per_heliostat(blocking_kernels.sigma_forward_plain, inputs, parameters, torch.float64)
    plain_grads = _per_heliostat(
        blocking_kernels.sigma_backward_plain, inputs + (gbar,), parameters, torch.float32
    )
    reference_grads = _per_heliostat(
        blocking_kernels.sigma_backward_plain, inputs + (gbar,), parameters, torch.float64
    )
    worst = {
        "sigma": _arbitrate(f"{label} sigma", sigma, plain, reference),
        "mask": _arbitrate(
            f"{label} mask", 1.0 - torch.exp(-alpha * sigma), 1.0 - torch.exp(-alpha * plain),
            1.0 - torch.exp(-alpha * reference),
        ),
    }
    for name, k, p, r in zip(("origins", "directions"), grads, plain_grads, reference_grads):
        worst[name] = _arbitrate(f"{label} cotangent of {name}", k, p, r)
    worst["columns"] = max(
        _arbitrate(f"{label} cotangent of column {c}", grads[2][..., c], plain_grads[2][..., c], reference_grads[2][..., c])
        for c in range(blocking_kernels.NUM_COLUMNS)
    )
    blocked_share = float((1.0 - torch.exp(-alpha * reference) >= 1e-3).double().mean())
    return dict(
        worst_share=worst,
        forward_err=_largest((sigma - plain).abs()),
        backward_err=max(_largest((k - p).abs()) for k, p in zip(grads, plain_grads)),
        cotangent_scale=max(_largest(r.abs()) for r in reference_grads),
        sigma_max=_largest(reference),
        blocked_share=blocked_share,
        kept_candidates=int(inputs[4].sum()),
    )


def _largest(x: torch.Tensor) -> float:
    """The largest entry of ``x`` that is not NaN (0 for none): the edge cases' NaN
    inputs give NaN outputs, which the arbiter has matched already."""
    x = x[~x.isnan()]
    return float(x.max()) if x.numel() else 0.0


def sigma_pair_counts(inputs, parameters, gbar) -> dict[str, int]:
    """What the sigma pair's work is on ``inputs``: the heliostats that meet no kept
    candidate (and the 256-ray blocks of theirs); the kept (ray, candidate) pairs;
    of those, the pairs whose sigma is exactly 0, by cause: beyond the ray's target
    hit (``t > t_target``) alone, overflowing gates alone (``gates_overflow``), both,
    or neither (gates whose product overflows though no two of them reach the
    test's threshold); and the pairs the kernels leave after their geometry
    (``kernels.blocking.gated_pair_exits``), forward and backward. Counted from the
    fp32 plain version's terms, a candidate slot at a time, so a pair at a gate's
    edge may count otherwise than the kernel's own rounding decides."""
    origins, directions, t_target, columns, keep = inputs
    softness, offset, epsilon = parameters
    rays = directions.shape[1]
    ray_terms = blocking_kernels._rays(origins, directions)
    none_kept = int((keep == 0).all(dim=1).sum())
    counts = dict(
        heliostats_none_kept=none_kept, ray_blocks_none_kept=none_kept * -(-rays // 256), kept_pairs=0,
        zero_sigma=0, zero_beyond_target=0, zero_overflow=0, zero_both=0, zero_otherwise=0,
        left_early_forward=0, left_early_backward=0,
    )
    for k in range(columns.shape[1]):
        rows = torch.nonzero(keep[:, k]).flatten()
        if rows.numel() == 0:
            continue
        weight, gated = keep[rows, k, None], t_target[rows]
        sigma, pair = blocking_kernels._pair_terms(
            tuple(x[rows] for x in ray_terms), columns[rows, k], gated, softness, offset, epsilon
        )
        beyond = pair["t"] > gated
        overflow = blocking_kernels.gates_overflow(pair, softness, offset)
        det = 1.0 / columns[rows, k, 15, None]
        zero = sigma == 0
        counts["kept_pairs"] += sigma.numel()
        counts["zero_sigma"] += int(zero.sum())
        counts["zero_beyond_target"] += int((zero & beyond & ~overflow).sum())
        counts["zero_overflow"] += int((zero & overflow & ~beyond).sum())
        counts["zero_both"] += int((zero & beyond & overflow).sum())
        counts["zero_otherwise"] += int((zero & ~beyond & ~overflow).sum())
        counts["left_early_forward"] += int(
            blocking_kernels.gated_pair_exits(pair, gated, weight, torch.ones_like(det), softness, offset).sum()
        )
        counts["left_early_backward"] += int(
            blocking_kernels.gated_pair_exits(pair, gated, gbar[rows] * weight, det, softness, offset).sum()
        )
    return counts


def time_sigma_pair(inputs, parameters, gbar, counts: dict) -> dict[str, dict]:
    """The sigma kernels' times on ``inputs`` with CUDA events and replayed from a CUDA
    graph (the device alone, without the wrappers' host work), the plain versions'
    times, and the card's bound for the same work: the kept pairs' operations or the
    bytes of every input the function needs read once and every output written
    once, whichever takes longer. A heliostat with no kept candidate has sigma 0
    and zero cotangents whatever its rays are, so only its outputs count; a pair
    whose sigma and cotangents are exactly 0 (``counts``, :func:`sigma_pair_counts`)
    needs only its geometry and the test, SIGMA_ZERO_PAIR_OPS."""
    origins, directions, t_target, columns, keep = inputs
    num, points = origins.shape[:2]
    rays, candidates = directions.shape[1], columns.shape[1]
    kept = float(keep.sum())
    pairs = rays * kept  # the kernels skip keep = 0 slots
    zero_forward, zero_backward = counts["left_early_forward"], counts["left_early_backward"]
    needed = float((keep.sum(dim=1) > 0).sum())  # heliostats with a kept candidate
    # Forward: per ray, sigma 4 written, and where needed direction 16 and
    # t_target 4 read; per needed point, origin 16 read; per slot, keep 4 read,
    # and per kept slot its 16 columns 64.
    forward_bytes = 4 * num * rays + 4 * num * candidates + needed * (20 * rays + 16 * points) + 64 * kept
    # Backward: the direction cotangent 16 per ray, the origin cotangent 16 per
    # point and the column cotangents 64 per slot written; keep 4 per slot
    # read; where needed, per ray direction 16, t_target 4 and gbar 4 read and
    # per point origin 16; per kept slot its columns 64.
    backward_bytes = (
        16 * num * rays + 16 * num * points + 68 * num * candidates
        + needed * (24 * rays + 16 * points) + 64 * kept
    )
    forward_ops = SIGMA_FORWARD_OPS_PER_PAIR * (pairs - zero_forward) + SIGMA_ZERO_PAIR_OPS * zero_forward
    backward_ops = SIGMA_BACKWARD_OPS_PER_PAIR * (pairs - zero_backward) + SIGMA_ZERO_PAIR_OPS * zero_backward
    forward = lambda: blocking_kernels.sigma_forward_cuda(*inputs, *parameters)  # noqa: E731
    backward = lambda: blocking_kernels.sigma_backward_cuda(*inputs, gbar, *parameters)  # noqa: E731
    return {
        "blocking_sigma_forward": dict(
            ms=event_ms(forward),
            graph_ms=graph_ms(forward),
            plain_ms=event_ms(lambda: blocking_kernels.sigma_forward_plain(*inputs, *parameters), 3, 1),
            bound=bound_ms(forward_bytes, forward_ops),
            pairs=pairs,
            zero_pairs=zero_forward,
        ),
        "blocking_sigma_backward": dict(
            ms=event_ms(backward),
            graph_ms=graph_ms(backward),
            plain_ms=event_ms(lambda: blocking_kernels.sigma_backward_plain(*inputs, gbar, *parameters), 3, 1),
            bound=bound_ms(backward_bytes, backward_ops),
            pairs=pairs,
            zero_pairs=zero_backward,
        ),
    }


def sigma_inputs(device: torch.device, row_spacing: float | None, candidates: int):
    """The sigma operator's inputs and parameters in the aim-point path's
    epoch-0 forward at full size, the field's rows ``row_spacing`` apart if given."""
    scenario = aim_point_scenario(device, AIM_HELIOSTATS, AIM_SURFACE_POINTS, AIM_RAYS, row_spacing)
    optimizer = aim_point_optimizer(scenario, aim_point_ground_truth(BITMAP, device), 0, candidates, BITMAP)
    return first_epoch(optimizer)[3]["blocking_sigma"]


# Phase 3b's inputs: (label, key in the kernel line, row spacing, K, every slot
# kept). The first is the aim-point path's own; the dense rows must block; with
# every slot kept, each ray meets K candidates (the operation-bound end of the
# kernels' range). At K = 32, where the TPU path splits its backward in two
# (its rows 11-12), the candidate order is also reversed: the corridor test
# ranks the nearest blockers first, so this puts them in slots 16-31, and a
# kernel that mishandled those slots would lose the blocking there.
SIGMA_CASES = (
    ("aim-point field", None, None, AIM_CANDIDATES, False),
    ("dense rows", "dense_rows", DENSE_ROW_SPACING, AIM_CANDIDATES, False),
    ("dense rows, all 16 slots kept", "all_kept", DENSE_ROW_SPACING, AIM_CANDIDATES, True),
    ("dense rows, all 32 slots kept, reversed", "all_kept_k32", DENSE_ROW_SPACING, 2 * AIM_CANDIDATES, True),
)


# The path's blocking parameters: softness, ray origin offset, epsilon.
GATED_EDGE_PARAMETERS = (1000.0, 0.05, 1e-12)
GATED_EDGE_POINTS = 261  # two tiles of 256 points, the second ragged; N = 522 rays, no multiple of 4
GATED_EDGE_RAYS = 2


def gated_edge_cases(candidates: int, seed: int = SEED) -> tuple[np.ndarray, ...]:
    """Hand-built compacted sigma inputs at the gates' edges, as float32 numpy arrays:
    ``origins [6, P, 4]``, ``directions [6, N, 4]``, ``t_target [6, N]``, ``columns [6,
    K, 16]``, ``keep [6, K]`` and ``gbar [6, N]`` (N = 2 P, ray i = r P + p; K =
    ``candidates``, 16 or 32; the parameters are GATED_EDGE_PARAMETERS).

    Candidate slot k is the unit square x in [2k, 2k + 1], z in [2k, 2k + 1] in the
    plane y = 2 with normal -y (columns of exact values), unless a heliostat moves
    it. A ray from (2k + a, 0, 2k + b) along +y meets it at t = 2 exactly, at local
    coordinates (a, b), and every other slot far outside (its gates overflow).
    Heliostat 0: slots 0, 2 and 5 kept with keep = 0 slots between them; rays at
    t = t_target exactly and one fp32 step either side of it, and one with
    t_target = -1e30. Heliostat 1: slot 1 moved to y = -1, behind the rays
    (t = -1); rays whose u, v or t gate alone saturates (sigma ~1e-35, not 0) and
    whose gates overflow in u and v, u and t, v and t, all three, and at the
    overflow test's threshold. Heliostat 2: slot 3 moved behind slot 0 (y = 3), so
    that rays cross both. Heliostat 3: nothing kept. Heliostat 4: every slot kept, a
    NaN origin, an infinite direction, and a ray with gbar = 0 (a keep = 0 slot adds
    exact zeros in the kernels, which skip it, where the plain version's 0 x NaN is
    NaN, so no slot of this heliostat is dropped). Heliostat 5: slots 14 and 15 (K =
    16) or 16, 19 and 31 (K = 32) kept. Every other point aims at a kept slot of its
    heliostat near the square's edges (|a| or |b| or |1 - a| or |1 - b| < 0.005,
    where the gates are soft), with directions tilted by ~2e-3 and t_target
    uniform in [1, 4], from ``seed``.
    """
    rng = np.random.RandomState(seed)
    heliostats, points, rays = 6, GATED_EDGE_POINTS, GATED_EDGE_RAYS
    late = [14, 15] if candidates <= 16 else [16, 19, 31]
    kept = [[0, 2, 5], [0, 1], [0, 1, 3], [], list(range(candidates)), late]
    moved = {(1, 1): (2.0, -1.0, 2.0), (2, 3): (0.0, 3.0, 0.0)}  # (heliostat, slot): corner
    columns = np.zeros((heliostats, candidates, 16), np.float32)
    keep = np.zeros((heliostats, candidates), np.float32)
    corners = np.zeros((heliostats, candidates, 3), np.float32)
    for m in range(heliostats):
        for k in range(candidates):
            x0, y0, z0 = moved.get((m, k), (2.0 * k, 2.0, 2.0 * k))
            corners[m, k] = x0, y0, z0
            # n = -y, u = x, v = z: c0.n, c0.u, c0.v, u.u, v.v, u.v, 1 / det.
            columns[m, k] = [0, -1, 0, 1, 0, 0, 0, 0, 1, -y0, x0, z0, 1, 1, 0, 1]
        keep[m, kept[m]] = 1.0
    up = np.array([0.0, 1.0, 0.0], np.float32)
    origins = np.zeros((heliostats, points, 4), np.float32)
    origins[..., 3] = 1.0
    directions = np.zeros((heliostats, rays, points, 4), np.float32)
    t_target = np.zeros((heliostats, rays, points), np.float32)

    def aim(m, p, k, a, b, targets, tilts=(None, None)):
        """Point p of heliostat m at local (a, b) of slot k; its rays' t_target and directions."""
        x0, _, z0 = corners[m, k]
        origins[m, p, :3] = x0 + a, 0.0, z0 + b
        for r in range(rays):
            directions[m, r, p, :3] = up if tilts[r] is None else tilts[r]
            t_target[m, r, p] = targets[r]

    below, above = np.nextafter(np.float32(2), np.float32(0)), np.nextafter(np.float32(2), np.float32(4))
    fixed = {
        0: [(0, 0.5, 0.5, (2.0, below)), (2, 0.5, 0.25, (above, -1e30)), (5, 0.25, 0.75, (2.0, 10.0)),
            (1, 0.5, 0.5, (10.0, 10.0))],  # slot 1 is not kept
        1: [(0, -0.1, 0.5, (10.0, 10.0)), (0, 0.5, 1.1, (10.0, 10.0)), (1, 0.5, 0.5, (10.0, 10.0)),
            (0, -0.1, 1.2, (10.0, 10.0)), (1, -0.1, 0.5, (10.0, 10.0)), (1, 0.5, 1.2, (10.0, 10.0)),
            (1, -0.1, 1.2, (10.0, 10.0)), (0, -0.045, -0.045, (10.0, 10.0))],
        4: [(0, 0.5, 0.5, (10.0, 10.0)), (0, 0.25, 0.5, (10.0, 10.0)), (0, 0.75, 0.5, (10.0, 10.0))],
    }
    for m in range(heliostats):
        rows = fixed.get(m, [])
        for p, (k, a, b, targets) in enumerate(rows):
            aim(m, p, k, a, b, targets)
        for p in range(len(rows), points):
            k = rng.choice(kept[m]) if kept[m] else rng.randint(candidates)
            edge = rng.choice([0.0, 1.0], 2) + rng.uniform(-0.005, 0.005, 2)
            a, b = np.where(rng.rand(2) < 0.5, edge, rng.uniform(-0.02, 1.02, 2))
            tilts = [up + rng.normal(0.0, 2e-3, 3).astype(np.float32) for _ in range(rays)]
            aim(m, p, k, a, b, rng.uniform(1.0, 4.0, rays), [t / np.linalg.norm(t) for t in tilts])
    origins[4, 0, 0] = np.nan
    directions[4, 0, 1, 0] = np.inf  # ray 1 (r = 0, p = 1)
    gbar = rng.standard_normal((heliostats, rays, points)).astype(np.float32)
    gbar[4, 0, 2] = 0.0
    n = rays * points
    return origins, directions.reshape(heliostats, n, 4), t_target.reshape(heliostats, n), columns, keep, \
        gbar.reshape(heliostats, n)


def check_gated_edge_cases(device: torch.device) -> dict[int, dict]:
    """Phase 3b's edge cases (:func:`gated_edge_cases`) at K = 16 and K = 32: the sigma
    kernels held to the float64 arbiter (NaN exactly where it is NaN), and the kept
    pairs the kernels leave after their geometry. Returns, by K, check_sigma_pair's
    result and sigma_pair_counts'."""
    results = {}
    for candidates in (AIM_CANDIDATES, 2 * AIM_CANDIDATES):
        *arrays, gbar = (torch.tensor(x, device=device) for x in gated_edge_cases(candidates))
        inputs = tuple(arrays)
        result = check_sigma_pair(f"edge cases, K = {candidates}", inputs, GATED_EDGE_PARAMETERS, gbar)
        result["counts"] = sigma_pair_counts(inputs, GATED_EDGE_PARAMETERS, gbar)
        results[candidates] = result
    return results


def sigma_case(device: torch.device, label: str, spacing: float | None, candidates: int, all_kept: bool,
               check: bool = True) -> dict:
    """One of SIGMA_CASES: its inputs from the aim-point path, the sigma kernels held to
    the float64 arbiter (with ``check``), its counts (:func:`sigma_pair_counts`) and
    its timings (:func:`time_sigma_pair`)."""
    inputs, parameters = sigma_inputs(device, spacing, candidates)
    if inputs[3].shape[1] != candidates:
        raise AssertionError(f"{label}: K = {inputs[3].shape[1]}, asked {candidates}")
    if all_kept:
        columns = inputs[3].flip(1).contiguous() if candidates > AIM_CANDIDATES else inputs[3]
        inputs = inputs[:3] + (columns, torch.ones_like(inputs[4]))
    gbar = torch.randn(
        inputs[2].shape, device=device, generator=torch.Generator(device=device).manual_seed(SEED + 3)
    )
    result = check_sigma_pair(label, inputs, parameters, gbar) if check else {}
    result["counts"] = sigma_pair_counts(inputs, parameters, gbar)
    result["timings"] = time_sigma_pair(inputs, parameters, gbar, result["counts"])
    result["shape"] = (inputs[1].shape[0], inputs[1].shape[1], inputs[3].shape[1])
    return result


def describe_counts(counts: dict) -> str:
    """A phase line's account of :func:`sigma_pair_counts`."""
    return (
        f"heliostats with nothing kept {counts['heliostats_none_kept']} ({counts['ray_blocks_none_kept']} "
        f"256-ray blocks), kept pairs {counts['kept_pairs']}, of them sigma exactly 0 {counts['zero_sigma']} "
        f"(beyond the target hit {counts['zero_beyond_target']}, gates overflowing {counts['zero_overflow']}, "
        f"both {counts['zero_both']}, otherwise {counts['zero_otherwise']}), left early forward "
        f"{counts['left_early_forward']}, backward {counts['left_early_backward']}"
    )


def check_blocking_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 3b: the sigma kernels on the aim-point path's first-epoch inputs, on
    the same field with rows 3 m apart, and there with every candidate slot kept
    at K = 16 and K = 32, and on the edge cases (:func:`gated_edge_cases`); each held
    to the float64 arbiter, the first four timed with events and replayed from a
    CUDA graph, with their counts (:func:`sigma_pair_counts`). The phase line also
    gives the pair loops' instructions (``sass_counts``) and the floors they set
    with every slot kept at K = 16. The kernel table reports the first, the path's own."""
    results = {}
    for label, _, spacing, candidates, all_kept in SIGMA_CASES:
        results[label] = sigma_case(device, label, spacing, candidates, all_kept)
        torch.cuda.empty_cache()
    dense = results["dense rows"]
    if not (dense["sigma_max"] > 0.1 and dense["blocked_share"] > 0.05):
        raise AssertionError(
            f"dense rows: the check is vacuous (max sigma {dense['sigma_max']}, "
            f"blocked share {dense['blocked_share']})"
        )
    edges = check_gated_edge_cases(device)
    names = ("blocking_sigma_forward", "blocking_sigma_backward")
    all_kept = results[SIGMA_CASES[2][0]]["timings"]
    floors = sigma_floors(names, {n: all_kept[n]["pairs"] for n in names}, {n: all_kept[n]["zero_pairs"] for n in names})
    replaces = {
        "blocking_sigma_forward": "artist_tpu/kernels/blocking_pallas.py:240 (_sigma_forward_kernel, gated=True, pallas_call :883)",
        "blocking_sigma_backward": "artist_tpu/kernels/blocking_pallas.py:348 (_sigma_bwd_fused_kernel, pallas_call :930)",
    }
    errors = {"blocking_sigma_forward": "forward_err", "blocking_sigma_backward": "backward_err"}
    timings = {}
    for name, t in results[SIGMA_CASES[0][0]]["timings"].items():
        timings[name] = dict(
            t,
            library_ms=None,
            max_abs_err=max(r[errors[name]] for r in [*results.values(), *edges.values()]),
            replaces=replaces[name],
            **{
                key: {"ms": x["ms"], "graph_ms": x["graph_ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound"][0],
                      "bound_by": x["bound"][1], "pairs": x["pairs"], "zero_pairs": x["zero_pairs"],
                      "candidates": candidates}
                for label, key, _, candidates, _ in SIGMA_CASES[1:]
                for x in (results[label]["timings"][name],)
            },
        )
    _log(
        "phase 3b blocking kernels: "
        + "; ".join(
            f"{label} ([{r['shape'][0]}, {r['shape'][1]}] rays x K = {r['shape'][2]}): max sigma "
            f"{r['sigma_max']:.4g}, blocked share {r['blocked_share']:.4g}, kept candidates "
            f"{r['kept_candidates']}, {describe_counts(r['counts'])}, largest cotangent {r['cotangent_scale']:.4g}, "
            "worst share of the arbiter's limit "
            + json.dumps({k: round(v, 4) for k, v in r["worst_share"].items()})
            + ", "
            + ", ".join(
                f"{name} kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} ms replayed from a CUDA graph), plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['pairs']:.0f} kept pairs, "
                f"{t['zero_pairs']} of them with sigma 0)"
                for name, t in r["timings"].items()
            )
            for label, r in results.items()
        )
        + "".join(
            f"; edge cases, K = {k}: {describe_counts(r['counts'])}, largest cotangent {r['cotangent_scale']:.4g}, "
            "worst share of the arbiter's limit " + json.dumps({k: round(v, 4) for k, v in r["worst_share"].items()})
            for k, r in edges.items()
        )
        + "; "
        + describe_floors(floors, "with all 16 slots kept")
        + "; max |kernel - fp32 plain|: "
        + ", ".join(f"{name} {t['max_abs_err']:.3g}" for name, t in timings.items())
    )
    return timings


# --------------------------------------------------------------------------- #
# The flat route's kernels (phase 3c).
# --------------------------------------------------------------------------- #


def cull_edge_cases() -> list[tuple]:
    """Hand-built cull inputs and the keep flags they must give.

    Returns ``(name, origins [M, P, 4], directions [M, N, 4], t_target [M, N],
    own [M] (int64), aabb [3, 6], expected keep [3])`` numpy tuples. Primitive
    0 spans y in [1, 2] and primitive 1 y in [3, 4], both x and z in [-1, 1];
    primitive 2 spans x in [2, 3], y in [1, 2], z in [-1, 1]. The cases, one
    heliostat each unless named: the own primitive; a blocker beyond the
    target; direction components of exactly 0 and -0; a component of -1e-12,
    whose inverse is infinite (and NaN where the origin lies on the box's
    face: 0 x inf); t_target = -1e30; NaN and infinite directions (a minimum
    or maximum that drops NaN, fmaxf, keeps primitives 0 and 1 there). Then
    the kernel's own edges (4 rays a thread, 128 a warp, 1,024 a block): only
    the last of 3 heliostats' 2,100 rays hits anything, in a ragged last
    chunk; every primitive kept; 2,049 rays, of which only the 2,049th hits;
    2 heliostats of 100 rays, so that one lane holds rays of both, each
    owning the primitive its own rays hit. Last, the warp's interval test at
    its equalities: one warp's 128 rays, their directions all different and
    all finite, of which one alone hits, entering primitive 0 at t equal to
    its target (kept) or one float past it (dropped), or touching primitive 0's
    and 2's edges, where its entry equals its exit.
    """
    aabb = np.array([[-1, 1, -1, 1, 2, 1], [-1, 3, -1, 1, 4, 1], [2, 1, -1, 3, 2, 1]], np.float32)
    up, down = (0.0, 1.0, 0.0), (0.0, -1.0, 0.0)

    def case(name, points, directions, expected, t_target=10.0, own=-1):
        """``points [P, 3]`` or ``[M, P, 3]``, ``directions [N, 3]`` or ``[M, N, 3]``."""
        points = np.asarray(points, np.float32).reshape(-1, np.shape(points)[-2], 3)
        directions = np.asarray(directions, np.float32).reshape(points.shape[0], -1, 3)
        origins = np.ones(points.shape[:2] + (4,), np.float32)
        origins[..., :3] = points
        rays = np.zeros(directions.shape[:2] + (4,), np.float32)
        rays[..., :3] = directions
        t = np.full(rays.shape[:2], t_target, np.float32)
        own = np.broadcast_to(np.asarray(own, np.int64), (points.shape[0],)).copy()
        return name, origins, rays, t, own, aabb, np.array(expected, np.float32)

    # 3 heliostats x 350 points x 2 rays, all aimed away from the boxes but the very last.
    last_points = np.zeros((3, 350, 3))
    last_points[2, 349] = (2.5, 0, 0)
    last_directions = np.tile(down, (3, 700, 1))
    last_directions[2, 699] = up
    # 2,049 points, one ray each: the last one starts between primitives 0 and 1.
    ragged_points = np.zeros((2049, 3))
    ragged_points[2048] = (0, 2.5, 0)
    ragged_directions = np.tile(down, (2049, 1))
    ragged_directions[2048] = up
    # Heliostat 0 rises through primitives 0 and 1 and owns 0; heliostat 1 through 2, its own.
    mixed_points = np.stack([np.zeros((100, 3)), np.tile((2.5, 0, 0), (100, 1))])
    # One warp's 128 rays, every component of every direction in (0.5, 2], each
    # ray its own point. Ray 77 from the origin enters primitive 0 through its
    # y = 1 face at t = 1; the others start at x = 5 and move away from every
    # box. Over the bundle the bound of the entry is exactly 1.
    k = np.arange(128) / 127
    entry_points = np.stack([np.full(128, 5.0), -0.5 * k, np.zeros(128)], axis=1)
    entry_points[77] = 0
    entry_directions = np.stack([0.5 + 0.5 * k, 1 - 0.5 * k, 0.5 + 0.5 * (np.arange(128) * 37 % 128) / 127], axis=1)
    entry_directions[77] = (0.5, 1, 0.5)
    below_one = float(np.nextafter(np.float32(1), np.float32(0)))
    # Ray 127 from the origin touches primitive 0 on its edge x = y = 1 at t = 1
    # (entry equal to exit) and primitive 2 on its edge x = y = 2; the others
    # start at z = 5 and rise. Over the bundle the bounds of primitive 0's entry
    # and exit are both exactly 1.
    graze_points = np.tile((0.0, 0.0, 5.0), (128, 1))
    graze_points[127] = 0
    graze_directions = np.stack([1 + k, 1 - 0.5 * k, 0.5 + 0.5 * (np.arange(128) * 37 % 128) / 127], axis=1)
    graze_directions[127] = (1, 1, 0.5)
    return [
        case("own", [(0, 0, 0)], [up], [0, 1, 0], own=0),
        case("beyond_target", [(0, 0, 0)], [up], [1, 0, 0], t_target=2.5),
        case("zero_components", [(1.5, 0, 0), (2.5, 0, 0)], [up, (-0.0, 1.0, -0.0)], [0, 0, 1]),
        case("minus_1e-12", [(0.5, 0, 0)], [(-1e-12, 1, 0)], [1, 1, 0]),
        case("zero_times_inf", [(-1, 0, 0)], [(-1e-12, 1, 0)], [0, 0, 0]),
        case("t_target_-1e30", [(0, 0, 0)], [up], [0, 0, 0], t_target=-1e30),
        case("nan_inf_directions", [(0, 0, 0)],
             [(np.nan, 1, 0), (np.inf, 1, 0), (-np.inf, 1, 0), (0, np.inf, 0)], [0, 0, 0]),
        case("last_ray_only", last_points, last_directions, [0, 0, 1]),
        case("all_kept", [(0, 0, 0), (2.5, 0, 0)], [up, up], [1, 1, 1]),
        case("ragged_rays", ragged_points, ragged_directions, [0, 1, 0]),
        case("mixed_owners", mixed_points, np.tile(up, (2, 100, 1)), [0, 1, 0], own=[0, 2]),
        case("bundle_entry_at_target", entry_points, entry_directions, [1, 0, 0], t_target=1.0),
        case("bundle_entry_past_target", entry_points, entry_directions, [0, 0, 0], t_target=below_one),
        case("bundle_edge_graze", graze_points, graze_directions, [1, 0, 1]),
    ]


def check_cull_edge_cases(device: torch.device) -> int:
    """The cull kernel on each edge case: equal to its plain version and to the expected
    flags. Returns the number of cases."""
    cases = cull_edge_cases()
    for name, *arrays, expected in cases:
        tensors = [torch.tensor(x, device=device) for x in arrays]
        kernel = blocking_kernels.cull_cuda(*tensors).cpu().numpy()
        plain = blocking_kernels.cull_plain(*tensors).cpu().numpy()
        if not (np.array_equal(kernel, plain) and np.array_equal(kernel, expected)):
            raise AssertionError(f"cull edge case {name}: kernel {kernel}, plain {plain}, expected {expected}")
    return len(cases)


def flat_inputs(device: torch.device, row_spacing: float | None):
    """The cull's and the flat sigma operator's inputs in the flat aim-point path's
    epoch-0 forward at full size, the field's rows ``row_spacing`` apart if given:
    the cull's tensors, and the sigma operator's ``(tensors, parameters)``."""
    scenario = aim_point_scenario(device, AIM_HELIOSTATS, AIM_SURFACE_POINTS, AIM_RAYS, row_spacing)
    optimizer = aim_point_optimizer(scenario, aim_point_ground_truth(BITMAP, device), 0, None, BITMAP)
    captured = first_epoch(optimizer)[3]
    return captured["blocking_cull"][0], captured["blocking_sigma_flat"]


def _flat_per_heliostat(fn, rays, primitives, parameters, dtype, chunk: int = 10):
    """``fn(origins, directions, columns, keep, [gbar,] *parameters)`` over slices of the
    heliostat axis (float64 would not fit whole); the column cotangents are summed."""
    parts = []
    for start in range(0, rays[0].shape[0], chunk):
        origins, directions, *gbar = (x[start : start + chunk].to(dtype) for x in rays)
        parts.append(fn(origins, directions, *(x.to(dtype) for x in primitives), *gbar, *parameters))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    grad_origins, grad_directions, grad_columns = zip(*parts)
    return torch.cat(grad_origins), torch.cat(grad_directions), torch.stack(grad_columns).sum(dim=0)


def check_flat_sigma_pair(label: str, inputs, parameters, gbar, alpha: float = 100.0, chunk: int = 10) -> dict:
    """The flat sigma kernels against the plain version, fp32 and float64, on ``inputs``
    (origins, directions, columns, keep), held to the arbiter as in phase 3b; the plain
    versions take ``chunk`` heliostats at a time."""
    origins, directions, columns, keep = inputs
    sigma = blocking_kernels.sigma_flat_forward_cuda(*inputs, *parameters)
    grads = blocking_kernels.sigma_flat_backward_cuda(*inputs, gbar, *parameters)
    # sigma and the direction and column cotangents are sums in a fixed order.
    sigma_again = blocking_kernels.sigma_flat_forward_cuda(*inputs, *parameters)
    grads_again = blocking_kernels.sigma_flat_backward_cuda(*inputs, gbar, *parameters)
    torch.cuda.synchronize()
    for what, first, second in (("sigma", sigma, sigma_again), ("directions", grads[1], grads_again[1]),
                                ("columns", grads[2], grads_again[2])):
        if not torch.equal(first, second):
            raise AssertionError(f"{label}: two launches differ in {what}")
    del sigma_again, grads_again
    rays, primitives = (origins, directions), (columns, keep)
    forward, backward = blocking_kernels.sigma_flat_forward_plain, blocking_kernels.sigma_flat_backward_plain
    plain = _flat_per_heliostat(forward, rays, primitives, parameters, torch.float32, chunk)
    reference = _flat_per_heliostat(forward, rays, primitives, parameters, torch.float64, chunk)
    plain_grads = _flat_per_heliostat(backward, rays + (gbar,), primitives, parameters, torch.float32, chunk)
    reference_grads = _flat_per_heliostat(backward, rays + (gbar,), primitives, parameters, torch.float64, chunk)
    worst = {
        "sigma": _arbitrate(f"{label} flat sigma", sigma, plain, reference),
        "mask": _arbitrate(
            f"{label} flat mask", 1.0 - torch.exp(-alpha * sigma), 1.0 - torch.exp(-alpha * plain),
            1.0 - torch.exp(-alpha * reference),
        ),
    }
    for name, k, p, r in zip(("origins", "directions"), grads, plain_grads, reference_grads):
        worst[name] = _arbitrate(f"{label} flat cotangent of {name}", k, p, r)
    worst["columns"] = max(
        _arbitrate(f"{label} flat cotangent of column {c}", grads[2][:, c], plain_grads[2][:, c],
                   reference_grads[2][:, c])
        for c in range(blocking_kernels.NUM_COLUMNS)
    )
    return dict(
        worst_share=worst,
        forward_err=float((sigma - plain).abs().max()),
        backward_err=max(float((k - p).abs().max()) for k, p in zip(grads, plain_grads)),
        cotangent_scale=max(float(r.abs().max()) for r in reference_grads),
        sigma_max=float(reference.max()),
        blocked_share=float((1.0 - torch.exp(-alpha * reference) >= 1e-3).double().mean()),
    )


def flat_zero_pairs(origins, directions, columns, keep,
                    softness: float, ray_origin_offset: float, epsilon: float) -> int:
    """How many (ray, kept primitive) pairs the flat sigma kernels leave after their
    geometry (``kernels.blocking.gates_overflow``), for their bounds' operation counts."""
    num = origins.shape[0]
    rays = blocking_kernels._rays(origins, directions)
    count = 0
    for b in torch.nonzero(keep).flatten().tolist():
        column = columns[b].expand(num, blocking_kernels.NUM_COLUMNS)
        _, pair = blocking_kernels._pair_terms(rays, column, None, softness, ray_origin_offset, epsilon)
        count += int(blocking_kernels.gates_overflow(pair, softness, ray_origin_offset).sum())
    return count


def time_flat_kernels(cull_inputs, sigma_inputs, parameters, gbar) -> dict[str, dict]:
    """The flat route's kernels' and plain versions' times on the path's inputs, and
    the card's bound for the same work (as :func:`time_sigma_pair`). With no
    primitive kept, sigma is 0 and every cotangent 0 whatever the rays are, so
    the sigma pair's bounds count only the keep flags read and the outputs
    written; with one kept, every ray must be read."""
    origins, directions, t_target, own, aabb = cull_inputs
    columns, keep = sigma_inputs[2:]
    num, points = origins.shape[:2]
    total, primitives = num * directions.shape[1], columns.shape[0]
    kept = keep.double()
    kept_count = float(kept.sum())
    needed = 1.0 if kept_count > 0 else 0.0
    # A cull that tests (ray, primitive) pairs needs, for a primitive it drops,
    # every ray that another heliostat owns, and for one it keeps a single hit;
    # with bundle tests, every primitive it drops against every bundle.
    owned_rays = torch.bincount(own[own >= 0], minlength=primitives)[:primitives].double() * directions.shape[1]
    cull_pairs = float(((total - owned_rays) * (1.0 - kept)).sum() + kept.sum())
    bundles = -(-total // CULL_BUNDLE_RAYS)
    cull_ops = CULL_OPS_PER_BUNDLE * bundles * (primitives - kept_count) + CULL_OPS_PER_PAIR * kept_count
    pairs = total * kept_count  # the sigma kernels skip keep = 0 primitives
    zero_pairs = flat_zero_pairs(*sigma_inputs, *parameters) if kept_count else 0
    forward_ops = SIGMA_FORWARD_OPS_PER_PAIR * (pairs - zero_pairs) + SIGMA_ZERO_PAIR_OPS * zero_pairs
    backward_ops = SIGMA_BACKWARD_OPS_PER_PAIR * (pairs - zero_pairs) + SIGMA_ZERO_PAIR_OPS * zero_pairs
    # Cull: per ray, direction 16 and t_target 4 read; per point, origin 16;
    # per heliostat, own 8; per primitive, its box 24 read and keep 4 written.
    cull_bytes = 20 * total + 16 * num * points + 8 * num + 28 * primitives
    # Forward: per ray, sigma 4 written; per primitive, keep 4 read, and per kept
    # one its 16 columns 64; if any is kept, per ray direction 16 and per point
    # origin 16 read.
    forward_bytes = 4 * total + 4 * primitives + 64 * kept_count + needed * (16 * total + 16 * num * points)
    # Backward: per ray the direction cotangent 16, per point the origin
    # cotangent 16 and per primitive the column cotangents 64 written; keep 4
    # per primitive and columns 64 per kept one read; if any is kept, per ray
    # direction 16 and gbar 4 and per point origin 16 read.
    backward_bytes = (
        16 * total + 16 * num * points + 68 * primitives + 64 * kept_count
        + needed * (20 * total + 16 * num * points)
    )
    return {
        "blocking_cull": dict(
            ms=event_ms(lambda: blocking_kernels.cull_cuda(*cull_inputs)),
            plain_ms=event_ms(lambda: blocking_kernels.cull_plain(*cull_inputs), 3, 1),
            bound=bound_ms(cull_bytes, cull_ops, PEAK_FP32_INSTRUCTIONS_PER_S),
            pairs=cull_pairs,
            issue_ms=CULL_OPS_PER_PAIR * cull_pairs / PEAK_FP32_INSTRUCTIONS_PER_S * 1e3,
        ),
        "blocking_sigma_flat_forward": dict(
            ms=event_ms(lambda: blocking_kernels.sigma_flat_forward_cuda(*sigma_inputs, *parameters)),
            graph_ms=graph_ms(lambda: blocking_kernels.sigma_flat_forward_cuda(*sigma_inputs, *parameters)),
            plain_ms=event_ms(lambda: blocking_kernels.sigma_flat_forward_plain(*sigma_inputs, *parameters), 3, 1),
            bound=bound_ms(forward_bytes, forward_ops),
            pairs=pairs,
            zero_pairs=zero_pairs,
        ),
        "blocking_sigma_flat_backward": dict(
            ms=event_ms(lambda: blocking_kernels.sigma_flat_backward_cuda(*sigma_inputs, gbar, *parameters)),
            graph_ms=graph_ms(lambda: blocking_kernels.sigma_flat_backward_cuda(*sigma_inputs, gbar, *parameters)),
            plain_ms=event_ms(
                lambda: blocking_kernels.sigma_flat_backward_plain(*sigma_inputs, gbar, *parameters), 3, 1
            ),
            bound=bound_ms(backward_bytes, backward_ops),
            pairs=pairs,
            zero_pairs=zero_pairs,
        ),
    }


# Phase 3c's inputs: (label, key in the kernel line, row spacing). The first is
# the flat aim-point path's own; on the dense rows the check must not be vacuous.
FLAT_CASES = (("aim-point field", None, None), ("dense rows", "dense_rows", DENSE_ROW_SPACING))
# The dense rows' primitives repeated three times (B = 300) against the rays of
# their last heliostats, twice. First with the cull's keep flags on the last 25
# heliostats' rays: the back rows, whose own boxes and front neighbours are the
# primitives kept, so that some are kept past 128 and past 256 and the
# kernels' gather must pick them out of every 256 flags (95 kept). Then with
# every primitive kept, as the flat route keeps them without target distances,
# on the last 9 heliostats' rays: past the forward's 256-primitive tile and
# through the backward's second and third 128-primitive passes. Neither ray
# count (2 M, 720 K) is a whole number of ray tiles (256 rays forward, 256 to
# 1,024 backward).
MANY_PRIMITIVES = dict(copies=3, heliostats=25, all_kept_heliostats=9)


def check_many_primitives(cull_inputs, sigma_inputs, parameters) -> dict[str, dict]:
    """The flat kernels on MANY_PRIMITIVES: the cull bit for bit, the sigma pair to the
    arbiter with the cull's keep flags ("culled") and with every primitive kept ("all kept")."""
    copies, heliostats = MANY_PRIMITIVES["copies"], MANY_PRIMITIVES["heliostats"]
    origins, directions, t_target, own = (x[-heliostats:] for x in cull_inputs[:4])
    aabb = cull_inputs[4].repeat(copies, 1)
    keep = blocking_kernels.cull_cuda(origins, directions, t_target, own, aabb)
    plain_keep = blocking_kernels.cull_plain(origins, directions, t_target, own, aabb)
    if not torch.equal(keep, plain_keep):
        raise AssertionError("many primitives: the cull kernel differs from its plain version")
    if not (keep[128:256].sum() > 0 and keep[256:].sum() > 0):
        raise AssertionError(f"many primitives: no primitive kept past 128 or past 256 ({keep.tolist()})")
    columns = sigma_inputs[2].repeat(copies, 1)
    gbar = torch.randn(
        directions.shape[:2], device=origins.device, generator=torch.Generator(device=origins.device).manual_seed(SEED + 6)
    )
    results = {}
    for label, flags, last in (("culled", keep, heliostats),
                               ("all kept", torch.ones_like(keep), MANY_PRIMITIVES["all_kept_heliostats"])):
        inputs = (origins[-last:], directions[-last:], columns, flags)
        # All their heliostats at once: the plain versions' cost is per primitive and slice.
        result = check_flat_sigma_pair(f"many primitives, {label}", inputs, parameters, gbar[-last:], chunk=last)
        result["kept_primitives"] = int(flags.sum())
        result["shape"] = (last, directions.shape[1], flags.numel())
        results[label] = result
    return results


# The sigma kernels whose pair loops sigma_floors reads, by the name in the kernel line.
SIGMA_LOOP_KERNELS = {
    "blocking_sigma_forward": "sigma_forward_kernel",
    "blocking_sigma_backward": "sigma_backward_kernel",
    "blocking_sigma_flat_forward": "sigma_flat_forward_kernel",
    "blocking_sigma_flat_backward": "sigma_flat_backward_kernel",
}


def sigma_floors(names, pairs: dict[str, float], zero_pairs: dict[str, float]) -> dict[str, dict | None] | None:
    """The sigma kernels ``names`` (keys of SIGMA_LOOP_KERNELS) and their pair loops as
    compiled (``sass_counts``: instructions per pair by class) and their floors at
    ``pairs[name]`` pairs, ``zero_pairs[name]`` of them left after their geometry: the
    instructions at the card's issue rate and the MUFU operations at the MUFU pipe's
    rate. The floors are a reading, not a check: None for a kernel whose pair loop
    the tool does not find, and None for all where ``cuobjdump`` is missing or fails."""
    try:
        loops = sass_counts.loop_counts(build_library("blocking")[0])
    except (OSError, subprocess.CalledProcessError):
        return None
    floors = {}
    for name in names:
        loop = loops.get(SIGMA_LOOP_KERNELS[name])
        floors[name] = loop and dict(
            per_pair=loop["per_pair"], **sass_counts.floors_ms(loop, pairs[name], zero_pairs[name])
        )
    return floors


def describe_floors(floors: dict[str, dict | None] | None, where: str) -> str:
    """A phase line's account of :func:`sigma_floors`."""
    if floors is None:
        return "sigma pair-loop floors not available (cuobjdump missing or failed)"
    return "; ".join(
        f"{name} pair loop "
        + (f"{json.dumps({k: v if v is None else round(v, 2) for k, v in f['per_pair'].items()})} instructions a "
           f"pair, floors {where}: issue {f['issue_ms']:.4f} ms, MUFU {f['mufu_ms']:.4f} ms"
           if f else "not found in the SASS")
        for name, f in floors.items()
    )


def check_flat_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 3c: the flat route's kernels on the flat aim-point path's first-epoch
    inputs, on the same field with rows 3 m apart, and there with its primitives
    repeated (MANY_PRIMITIVES). The cull equals its plain version bit for bit (and
    the keep flags the path used); the sigma pair is held to the float64 arbiter
    and gives the same sigma and direction and column cotangents at every launch;
    each is timed on the first two. The phase line also gives the sigma
    pair's pair-loop instructions (``sass_counts``) and the floors they set on the
    dense rows. The kernel table reports the first field."""
    results = {}
    for label, _, spacing in FLAT_CASES:
        cull_inputs, (sigma_inputs, parameters) = flat_inputs(device, spacing)
        keep = blocking_kernels.cull_cuda(*cull_inputs)
        plain_keep = blocking_kernels.cull_plain(*cull_inputs)
        if not (torch.equal(keep, plain_keep) and torch.equal(keep, sigma_inputs[3])):
            raise AssertionError(
                f"{label}: cull kernel keeps {keep.nonzero().flatten().tolist()}, plain version "
                f"{plain_keep.nonzero().flatten().tolist()}, the path {sigma_inputs[3].nonzero().flatten().tolist()}"
            )
        gbar = torch.randn(
            sigma_inputs[1].shape[:2], device=device, generator=torch.Generator(device=device).manual_seed(SEED + 4)
        )
        result = check_flat_sigma_pair(label, sigma_inputs, parameters, gbar)
        result["timings"] = time_flat_kernels(cull_inputs, sigma_inputs, parameters, gbar)
        result["kept_primitives"] = int(keep.sum())
        result["shape"] = (sigma_inputs[1].shape[0], sigma_inputs[1].shape[1], keep.numel())
        results[label] = result
        if spacing is not None:
            many = check_many_primitives(cull_inputs, sigma_inputs, parameters)
        del cull_inputs, sigma_inputs, gbar
        torch.cuda.empty_cache()
    edge_cases = check_cull_edge_cases(device)
    dense = results["dense rows"]
    if not (dense["kept_primitives"] > 0 and dense["sigma_max"] > 0.1 and dense["blocked_share"] > 0.05):
        raise AssertionError(
            f"dense rows, flat: the check is vacuous ({dense['kept_primitives']} kept primitives, max sigma "
            f"{dense['sigma_max']}, blocked share {dense['blocked_share']})"
        )
    dense_timings = dense["timings"]
    flat_names = ("blocking_sigma_flat_forward", "blocking_sigma_flat_backward")
    floors = sigma_floors(
        flat_names, {n: dense_timings[n]["pairs"] for n in flat_names},
        {n: dense_timings[n]["zero_pairs"] for n in flat_names},
    )
    replaces = {
        "blocking_cull": "artist_tpu/kernels/blocking_pallas.py:414 (_cull_kernel, pallas_call :506)",
        "blocking_sigma_flat_forward":
            "artist_tpu/kernels/blocking_pallas.py:240 (_sigma_forward_kernel, gated=False, pallas_call :573)",
        "blocking_sigma_flat_backward":
            "artist_tpu/kernels/blocking_pallas.py:264 and :302 (_sigma_bwd_rays_kernel and "
            "_sigma_bwd_prims_kernel, gated=False, pallas_calls :604 and :627)",
    }
    # The cull is held bit for bit: its error is 0 wherever the check passed.
    errors = {"blocking_cull": None, "blocking_sigma_flat_forward": "forward_err",
              "blocking_sigma_flat_backward": "backward_err"}
    timings = {}
    for name, t in results[FLAT_CASES[0][0]]["timings"].items():
        timings[name] = dict(
            t,
            library_ms=None,
            max_abs_err=max(r[errors[name]] for r in results.values()) if errors[name] else 0.0,
            replaces=replaces[name],
            kept_primitives={key or "aim_point": results[label]["kept_primitives"] for label, key, _ in FLAT_CASES},
            **{
                key: {"ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound"][0],
                      "bound_by": x["bound"][1], "pairs": x["pairs"], "zero_pairs": x.get("zero_pairs")}
                for label, key, _ in FLAT_CASES[1:]
                for x in (results[label]["timings"][name],)
            },
        )
    _log(
        f"phase 3c flat kernels: cull bit-exact on {edge_cases} edge cases and on each field; "
        + "; ".join(
            f"{label} ([{r['shape'][0]}, {r['shape'][1]}] rays x B = {r['shape'][2]}): kept primitives "
            f"{r['kept_primitives']}, max sigma {r['sigma_max']:.4g}, blocked share {r['blocked_share']:.4g}, "
            f"largest cotangent {r['cotangent_scale']:.4g}, worst share of the arbiter's limit "
            + json.dumps({k: round(v, 4) for k, v in r["worst_share"].items()})
            + ", "
            + ", ".join(
                f"{name} kernel {t['ms']:.4f} ms"
                + (f" ({t['graph_ms']:.4f} ms replayed from a CUDA graph)" if "graph_ms" in t else "")
                + f", plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['pairs']:.0f} pairs"
                + (f", {t['zero_pairs']} of them with sigma 0)" if "zero_pairs" in t else ")")
                + (f", its pairs tested one by one ({CULL_OPS_PER_PAIR} instructions each) at the issue rate "
                   f"{t['issue_ms']:.4f} ms" if "issue_ms" in t else "")
                for name, t in r["timings"].items()
            )
            for label, r in results.items()
        )
        + "".join(
            f"; many primitives, {label} ([{r['shape'][0]}, {r['shape'][1]}] rays x B = {r['shape'][2]}): kept "
            f"primitives {r['kept_primitives']}, max sigma {r['sigma_max']:.4g}, worst share of the arbiter's limit "
            + json.dumps({k: round(v, 4) for k, v in r["worst_share"].items()})
            for label, r in many.items()
        )
        + "; "
        + describe_floors(floors, "on the dense rows")
        + "; max |kernel - fp32 plain|: "
        + ", ".join(f"{name} {t['max_abs_err']:.3g}" for name, t in timings.items())
    )
    return timings


def drive_aim_point(
    device: torch.device,
    candidates: int | None,
    phase: str,
    row_spacing: float | None = None,
    timed_epochs: int = AIM_EPOCHS,
) -> dict:
    """Phases 5 and 8: AimPointOptimizer.optimize at bench.py's aim-point size, on the
    compacted route with ``candidates`` per heliostat or, with None, the flat route;
    one warm-up and ``timed_epochs`` timed epochs, host clock around synchronised
    epochs. With ``row_spacing`` the field's rows are that far apart, and some
    heliostat's blocking factor must be below 1."""
    scenario = aim_point_scenario(device, AIM_HELIOSTATS, AIM_SURFACE_POINTS, AIM_RAYS, row_spacing)
    optimizer = aim_point_optimizer(
        scenario, aim_point_ground_truth(BITMAP, device), timed_epochs, candidates, BITMAP
    )
    epoch_ends = []

    def on_epoch(epoch: int, loss: float) -> None:
        torch.cuda.synchronize()
        epoch_ends.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = time.perf_counter()
    loss, history, intercepts, _, blockings = optimizer.optimize("kl_divergence", on_epoch=on_epoch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    epochs = 1 + timed_epochs
    expected = {
        name: AIM_LAUNCHES_PER_EPOCH[candidates][name] * epochs + AIM_LAUNCHES_PER_CALL[candidates][name]
        for name in KERNELS
    }
    if launches != expected:
        raise AssertionError(f"{phase} launched {launches}, expected {expected}")
    losses = history["total_loss"]
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: losses {losses}")
    motors = scenario.heliostat_groups[0].motor_positions
    moved = float((motors != optimizer.initial_motor_positions_all_groups[0]).double().mean())
    if not (torch.isfinite(motors).all() and moved > 0.5):
        raise AssertionError(f"{phase}: motor gradient vanished ({moved} of the motors moved)")
    if not torch.isfinite(blockings).all() or (row_spacing is not None and not float(blockings.min()) < 1.0):
        raise AssertionError(f"{phase}: blocking factors {blockings.tolist()}")
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]
    rays = AIM_HELIOSTATS * AIM_RAYS * 4 * AIM_SURFACE_POINTS[0] * AIM_SURFACE_POINTS[1]
    mean_epoch = sum(epoch_seconds) / len(epoch_seconds)
    result = dict(
        launches=launches,
        epoch_seconds=epoch_seconds,
        first_epoch_and_setup_seconds=epoch_ends[0] - start,
        optimize_seconds=seconds,
        rays_per_epoch=rays,
        rays_per_second=rays / mean_epoch,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=losses,
        blocking_factor_mean=float(blockings.mean()),
        blocking_factor_min=float(blockings.min()),
        intercept_mean=float(intercepts.mean()),
        motors_moved=moved,
    )
    field = "" if row_spacing is None else f", rows {row_spacing} m apart"
    _log(
        f"{phase}: optimize() with {epochs} epochs (1 warm-up) of {rays} rays, "
        f"{'flat route' if candidates is None else f'K = {candidates}'}{field}: "
        f"losses {losses}, timed epoch seconds {epoch_seconds} (mean {mean_epoch:.6f}), "
        f"{result['rays_per_second']:.6g} rays/s, setup + first epoch {result['first_epoch_and_setup_seconds']:.3f} s, "
        f"optimize() {seconds:.3f} s, max_memory_allocated {result['max_memory_allocated']} B, "
        f"mean blocking factor {result['blocking_factor_mean']:.6f} (least "
        f"{result['blocking_factor_min']:.6f}), mean intercept {result['intercept_mean']:.6f}, "
        f"motors moved {moved:.4f}, launches {launches}"
    )
    return result


SMALL = dict(heliostats=4, surface_points=(5, 5), rays=8, bitmap=(32, 32), ray_chunk=4)


def small_step(
    device: torch.device, distortions: np.ndarray, ground_truth: np.ndarray | None = None, size: dict = SMALL,
    **splat_options,
):
    """Flux, loss and control-point gradient of the step at ``size`` (SMALL) on ``device``;
    ``splat_options`` go into its RenderConfig."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=size["heliostats"],
        number_of_surface_points_per_facet=size["surface_points"],
        number_of_rays=size["rays"],
        device=device,
    )
    du, de = (torch.tensor(x, device=device) for x in distortions)
    inputs = step_inputs(scenario, du, de, size["surface_points"], size["bitmap"], size["ray_chunk"])
    inputs.config = dataclasses.replace(inputs.config, **splat_options)
    if ground_truth is not None:
        inputs.ground_truth = torch.tensor(ground_truth, device=device)
    control_points = scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    loss = surface_loss(control_points, inputs)
    loss.backward()
    with torch.no_grad():
        flux = render(control_points, inputs)[0]
    return flux.cpu(), loss.item(), control_points.grad.cpu()


# Phase 7c's small steps. The block-window route: 10 x 10 points a facet on a
# 64 x 64 bitmap, so that a heliostat's 1,600 rays of a chunk make two blocks,
# with 3 mrad sun distortions (the spot spans rows ~8-56) and 32-row windows
# over 5 x 5 point tiles, where half the blocks fit. The windowed route: phase
# 7a's scene with a 16-pixel window, which drops rays.
SMALL_WINDOW_STEP = dict(heliostats=4, surface_points=(10, 10), rays=8, bitmap=(64, 64), ray_chunk=4)
SMALL_BLOCK_WINDOW = dict(splat_block_window=32, splat_point_layout=(10, 10, 4), splat_point_tile=5)
SMALL_WINDOW = dict(splat_window=16)


def check_small_step_against_cpu(
    device: torch.device,
    phase: str = "phase 7a",
    spread: float = 1e-2,
    size: dict = SMALL,
    baseline: dict | None = None,
    **splat_options,
) -> dict:
    """Phases 7a and 7c: flux, loss and control-point gradient of a small step, ``device``
    vs CPU, at ``size``; ``splat_options`` (none in 7a) go into its RenderConfig,
    and the sun distortions have standard deviation ``spread``. Returns the
    launch counts of the step on ``device``.

    The CPU run takes the kernels' plain versions. The two differ by fp32
    rounding (atomic sum orders, fused multiply-adds, transcendental
    functions) through NURBS, alignment and the splat. Tolerances: flux 1e-4
    of its peak, loss rtol 1e-4, gradient 1e-3 of its largest entry; with a
    ``baseline`` (the errors of another step on the same scene), each may
    instead be the baseline's error plus 1e-5 of its scale. The gradient is
    taken under a ground truth of ones on the spot and zeros off it: under all
    ones, the KL gradient -p/q at a rim pixel holding one deposit of a ray
    ~1e-5 px from a cell edge turns ulp-level geometry differences into
    differences of tens of percent.
    """
    errors, launches, (loss_dev, loss_cpu) = small_step_errors(device, spread, size, **splat_options)
    limits = {}
    for what, (err, scale, relative) in errors.items():
        limits[what] = relative * scale
        if baseline is not None:
            limits[what] = max(limits[what], baseline[what][0] + 1e-5 * scale)
        if not err <= limits[what]:
            raise AssertionError(f"{phase} small step {what} differs between {device} and cpu: {err} > {limits[what]}")
    if not errors["control-point gradient"][1] > 0:
        raise AssertionError(f"{phase} small step: zero control-point gradient")
    _log(
        f"{phase} agreement: small surface step {splat_options or ''} on {device} vs cpu: loss {loss_dev} vs "
        f"{loss_cpu}; "
        + ", ".join(
            f"{what} max err {errors[what][0]:.3g} ({errors[what][0] / limits[what]:.3g} of its limit"
            + ("" if baseline is None else f"; full splat's {baseline[what][0]:.3g}")
            + ")"
            for what in errors
        )
        + f"; launches {launches}"
    )
    return launches


def small_step_errors(device: torch.device, spread: float, size: dict, spot_share: float = 0.05, **splat_options):
    """The small step at ``size`` on ``device`` and on the CPU: each quantity's
    ``(max |device - cpu|, scale, relative tolerance)``, the launch counts on
    ``device``, and both losses. The ground truth is ones where the CPU's flux
    exceeds ``spot_share`` of its peak, zeros elsewhere."""
    rng = np.random.RandomState(SEED)
    points = 4 * size["surface_points"][0] * size["surface_points"][1]
    # 7a: wider than the sun's 2.1 mrad so the spot covers much of the small bitmap.
    distortions = rng.normal(0.0, spread, (2, size["heliostats"], size["rays"], points)).astype(np.float32)
    flux_cpu, _, _ = small_step(torch.device("cpu"), distortions, None, size, **splat_options)
    spot = (flux_cpu > spot_share * flux_cpu.amax(dim=(1, 2), keepdim=True)).float().numpy()
    reset_launch_counts()
    flux_dev, loss_dev, grad_dev = small_step(device, distortions, spot, size, **splat_options)
    launches = launch_counts()
    flux_cpu, loss_cpu, grad_cpu = small_step(torch.device("cpu"), distortions, spot, size, **splat_options)
    errors = {
        "flux": (float((flux_dev - flux_cpu).abs().max()), float(flux_cpu.abs().max()), 1e-4),
        "loss": (abs(loss_dev - loss_cpu), abs(loss_cpu), 1e-4),
        "control-point gradient": (float((grad_dev - grad_cpu).abs().max()), float(grad_cpu.abs().max()), 1e-3),
    }
    return errors, launches, (loss_dev, loss_cpu)


def check_small_window_steps_against_cpu(device: torch.device) -> None:
    """Phase 7c: small steps with SMALL_BLOCK_WINDOW at SMALL_WINDOW_STEP and with
    SMALL_WINDOW at phase 7a's size, ``device`` vs CPU. The first scene's narrow
    spot leaves the control-point gradient ill-conditioned (the full splat's
    differs between the card and the CPU by ~2x phase 7a's limit there), so the
    full splat's step on it runs first, and the block-window step may differ from
    the CPU as much as that, plus 1e-5 of each quantity's scale. The windowed step
    is held to phase 7a's tolerances. On the card the block-window step must
    launch the dynamic-window pair and not the full splat's, the windowed step
    the full splat's."""
    full, _, losses = small_step_errors(device, 3e-3, SMALL_WINDOW_STEP)
    _log(
        f"phase 7c full splat on the block-window step's scene, {device} vs cpu: loss {losses[0]} vs {losses[1]}; "
        + ", ".join(f"{what} max err {err:.3g} ({err / (relative * scale):.3g} of phase 7a's limit)"
                    for what, (err, scale, relative) in full.items())
    )
    block = check_small_step_against_cpu(device, "phase 7c", 3e-3, SMALL_WINDOW_STEP, full, **SMALL_BLOCK_WINDOW)
    windowed = check_small_step_against_cpu(device, "phase 7c", **SMALL_WINDOW)
    if device.type == "cuda" and not (
        block["splat_dynamic_window_forward"] and block["splat_dynamic_window_backward"] and not block["splat_forward"]
        and windowed["splat_forward"] and windowed["splat_backward"] and not windowed["splat_dynamic_window_forward"]
    ):
        raise AssertionError(f"phase 7c: launches {block} with the block window, {windowed} with the window")


# The small aim-point step of the agreement phase: 48 heliostats in eight rows
# 3 m apart and six columns 3.5 m apart, the receiver's centre lowered to 10 m;
# 5 x 5 points per facet, 4 rays. The rays of a back-row heliostat then climb
# so slowly that they pass close over many heliostats, the corridor test keeps
# up to 20 candidates for a heliostat, and K = 32 fills slots 16-31 too.
# (Moving the field 250 m out instead keeps as many, but there fp32 rounding
# of the larger coordinates puts the card's flux more than 1e-4 of its peak
# from the CPU's.)
SMALL_AIM = dict(heliostats=48, surface_points=(5, 5), rays=4, bitmap=(64, 64))
SMALL_AIM_FIELD = dict(row_spacing=DENSE_ROW_SPACING, columns=6, column_spacing=3.5, receiver_height=10.0)


def small_aim_point_step(device: torch.device, candidates: int | None, distortions: np.ndarray, ground_truth=None):
    """The target's flux, the loss and the motor gradient of the first aim-point
    epoch on the SMALL_AIM field on ``device``; and the keep flags the sigma
    operator saw: ``[M, K]`` of the candidates, or on the flat route (None)
    ``[B]`` of the primitives."""
    scenario = aim_point_scenario(
        device, SMALL_AIM["heliostats"], SMALL_AIM["surface_points"], SMALL_AIM["rays"], **SMALL_AIM_FIELD
    )
    scenario.light_sources[0] = FixedDistortions(SMALL_AIM["rays"], *distortions)
    truth = torch.ones(SMALL_AIM["bitmap"][::-1], device=device) if ground_truth is None else ground_truth.to(device)
    optimizer = aim_point_optimizer(scenario, truth, 0, candidates, SMALL_AIM["bitmap"])
    params, loss_fn, (flux, intercepts, _, _), captured = first_epoch(optimizer)
    keep = captured["blocking_sigma"][0][4] if candidates else captured["blocking_sigma_flat"][0][3]
    references = (torch.sum(flux), intercepts)
    zero = torch.zeros((), device=device)
    params[0].requires_grad_(True)
    loss, _ = loss_fn(params, references, (zero, zero, zero))
    loss.backward()
    return flux.cpu(), loss.item(), params[0].grad.cpu(), keep.cpu()


def check_small_aim_point_against_cpu(device: torch.device) -> dict[int | None, dict]:
    """Phase 7b: the first aim-point epoch on the SMALL_AIM field, ``device`` vs
    CPU, at K = 16 and at K = 32 (the TPU path splits its backward in two above
    16), and on the flat route (None). At K = 32 some heliostat must keep a
    candidate in slots 16-31; on the flat route the cull must keep some
    primitives and drop others.

    The CPU run takes the kernels' plain versions. The tolerances are the
    surface step's: loss rtol 1e-4, flux 1e-4 of its peak, motor gradient
    1e-3 of its largest entry, under a ground truth of ones on the CPU's spot
    and zeros off it. The gates at softness 1000 turn ulp-level differences in
    ray geometry into differences of up to percents in the mask of the few
    rays that graze a blocker's edge, but those rays are too few to move the
    flux or the gradient by more than that.
    """
    rng = np.random.RandomState(SEED + 5)
    points = 4 * SMALL_AIM["surface_points"][0] * SMALL_AIM["surface_points"][1]
    shape = (SMALL_AIM["heliostats"], SMALL_AIM["rays"], points)
    distortions = rng.normal(0.0, 2e-3, (2,) + shape).astype(np.float32)
    results = {}
    for candidates in (AIM_CANDIDATES, 2 * AIM_CANDIDATES, None):
        route = "on the flat route" if candidates is None else f"at K = {candidates}"
        flux_cpu = small_aim_point_step(torch.device("cpu"), candidates, distortions)[0]
        spot = (flux_cpu > 0.05 * flux_cpu.max()).float()
        reset_launch_counts()
        flux_dev, loss_dev, grad_dev, keep_dev = small_aim_point_step(device, candidates, distortions, spot)
        launches = launch_counts()
        flux_cpu, loss_cpu, grad_cpu, keep_cpu = small_aim_point_step(torch.device("cpu"), candidates, distortions, spot)
        names = (("blocking_cull", "blocking_sigma_flat_forward", "blocking_sigma_flat_backward") if candidates is None
                 else ("blocking_sigma_forward", "blocking_sigma_backward"))
        if device.type == "cuda" and not all(launches[name] for name in names):
            raise AssertionError(f"small aim-point step {route}: a blocking kernel did not launch ({launches})")
        if candidates is None:
            if not torch.equal(keep_dev, keep_cpu) or not 0 < int(keep_dev.sum()) < keep_dev.numel():
                raise AssertionError(f"small aim-point step {route}: keep {keep_dev} on {device}, {keep_cpu} on cpu")
            kept_beyond_16 = 0
        elif not keep_dev.shape[1] == keep_cpu.shape[1] == candidates:
            raise AssertionError(
                f"small aim-point step: K = {keep_dev.shape[1]} on {device}, {keep_cpu.shape[1]} on cpu, asked {candidates}"
            )
        else:
            kept_beyond_16 = int(keep_dev[:, AIM_CANDIDATES:].sum())
        if candidates is not None and candidates > AIM_CANDIDATES and not kept_beyond_16 > 0:
            raise AssertionError(f"small aim-point step {route}: no candidate kept in slots 16-{candidates - 1}")
        checks = (
            (abs(loss_dev - loss_cpu), 1e-4 * abs(loss_cpu), "loss"),
            (float((flux_dev - flux_cpu).abs().max()), 1e-4 * float(flux_cpu.abs().max()), "flux"),
            (float((grad_dev - grad_cpu).abs().max()), 1e-3 * float(grad_cpu.abs().max()), "motor gradient"),
        )
        for err, limit, what in checks:
            if not err <= limit:
                raise AssertionError(
                    f"small aim-point step {route}: {what} differs between {device} and cpu: {err} > {limit}"
                )
        if not float(grad_cpu.abs().max()) > 0:
            raise AssertionError("small aim-point step: zero motor gradient")
        results[candidates] = {what: (err, limit) for err, limit, what in checks}
        results[candidates]["kept_beyond_16"] = kept_beyond_16
        kept = (f"{int(keep_dev.sum())} of {keep_dev.numel()} primitives kept by the cull" if candidates is None
                else f"most candidates kept by one heliostat {int(keep_dev.sum(dim=1).max())}, "
                f"kept in slots 16 and up {kept_beyond_16}")
        _log(
            f"phase 7b agreement: small aim-point step {route} on {device} vs cpu: loss {loss_dev} vs {loss_cpu}; "
            + ", ".join(f"{what} max err {err:.3g} ({err / limit:.3g} of its limit)" for err, limit, what in checks)
            + f"; {kept}; launches {launches}"
        )
    return results


# --------------------------------------------------------------------------- #
# The surface reconstructor (phases 7d and 12).
# --------------------------------------------------------------------------- #


def surface_reconstructor(
    device: torch.device,
    max_epoch: int,
    heliostats: int = RECON_HELIOSTATS,
    surface_points: tuple[int, int] = RECON_SURFACE_POINTS,
    rays: int = RECON_RAYS,
    bitmap: tuple[int, int] = BITMAP,
    ray_chunk: int | None = RECON_RAY_CHUNK,
    samples: int = RECON_SAMPLES,
    configuration: dict | None = None,
) -> SurfaceReconstructor:
    """A ``SurfaceReconstructor`` on the synthetic field with ``samples`` synthetic
    calibration samples a heliostat, at bench.py's production size by default."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=heliostats,
        number_of_control_points_per_facet=RECON_CONTROL_POINTS,
        number_of_surface_points_per_facet=surface_points,
        number_of_rays=rays,
        device=device,
    )
    return SurfaceReconstructor(
        scenario=scenario,
        data={
            constants.data_parser: SyntheticCalibrationParser(samples_per_heliostat=samples),
            constants.heliostat_data_mapping: [],
        },
        optimization_configuration=configuration or reconstruction_configuration(max_epoch),
        number_of_surface_points=surface_points,
        bitmap_resolution=bitmap,
        ray_chunk=ray_chunk,
        seed=SEED,
    )


def batch_inputs(reconstructor: SurfaceReconstructor, batch: dict) -> StepInputs:
    """A reconstructor's batch as the step's inputs: its samples, sun distortions and
    measured flux, at the reconstructor's surface points, resolution and ray chunks."""
    tower = reconstructor.scenario.solar_tower
    return StepInputs(
        scenario=reconstructor.scenario,
        active_indices=batch["active_indices"],
        target_area_indices=batch["target_area_indices"],
        incident_ray_directions=batch["incident_ray_directions"],
        aim_points=get_centers_of_target_areas(tower, batch["target_area_indices"]),
        distortions_u=batch["distortions_u"],
        distortions_e=batch["distortions_e"],
        ground_truth=batch["flux_measured"],
        surface_points_per_facet=reconstructor.number_of_surface_points,
        config=RenderConfig(bitmap_resolution=reconstructor.bitmap_resolution, ray_chunk=reconstructor.ray_chunk),
    )


def reconstruction_chunk_rays(device: torch.device):
    """The surface reconstructor's first train chunk at phase 12's configuration: ``[36, 120000]`` rays."""
    reconstructor = surface_reconstructor(device, RECON_EPOCHS[0])
    group = reconstructor.scenario.heliostat_groups[0]
    unique, split = training.group_calibration_split(
        reconstructor.data, reconstructor.scenario, group, reconstructor.bitmap_resolution
    )
    (batch,) = reconstructor._batches(group, split, unique, test=False)
    return first_chunk_rays(batch_inputs(reconstructor, batch))


def check_reconstruction_chunk(device: torch.device) -> dict[str, dict]:
    """Phase 12's kernel check: the splat pair against its plain versions at the
    reconstructor's first train chunk (``[36, 120000]`` rays onto ``[36, 256, 256]``),
    then timed. Returns the timings of each kernel."""
    width, height = BITMAP
    rays = reconstruction_chunk_rays(device)
    g = torch.randn(
        (rays[0].shape[0], height, width), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 3),
    )
    forward_err, forward_share = check_forward(
        "splat_forward", splat_forward_cuda(*rays, height, width), splat_forward_plain(*rays, height, width),
        rays, height, width,
    )
    backward_errs, backward_share = check_backward(
        "splat_backward", splat_backward_cuda(*rays, g, height, width), splat_backward_plain(*rays, g, height, width),
        rays[2], g,
    )
    timings, work = time_splat_pair(rays, g, height, width)
    timings["splat_forward"]["max_abs_err"] = forward_err
    timings["splat_backward"]["max_abs_err"] = max(backward_errs)
    shape = list(rays[0].shape)
    _log(
        f"phase 12 splat kernels at the reconstructor's train chunk: {shape} rays ({work['valid']} valid, "
        f"{work['touched']} pixels touched) -> [{shape[0]}, {height}, {width}], "
        f"{-(-height // band_layout(height, width, shared_limit(device))) * shape[0]} band blocks on "
        f"{torch.cuda.get_device_properties(device).multi_processor_count} SMs; worst error "
        f"{max(forward_share, backward_share):.3g} of its tolerance: "
        + "; ".join(
            f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} ms, "
            + describe_bound(t)
            for name, t in timings.items()
        )
    )
    return {
        name: dict(shape=shape, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"], bound_ms=t["bound"][0],
                   bound_by=t["bound"][1], max_abs_err=t["max_abs_err"])
        for name, t in timings.items()
    }


def check_reconstruction(label: str, reconstructor, original: torch.Tensor, final_loss, result, max_epoch: int):
    """Phase 12's checks of one run: a finite history of ``max_epoch + 1`` epochs, a
    finite final loss for every heliostat and finite test losses; control points
    that moved, and surfaces re-evaluated from them."""
    for key, values in result.loss_history.items():
        if len(values) != max_epoch + 1 or not np.isfinite(values).all():
            raise AssertionError(f"phase 12 {label}: history {key} {values}")
    if final_loss.shape != (RECON_HELIOSTATS,) or not np.isfinite(final_loss).all():
        raise AssertionError(f"phase 12 {label}: final loss per heliostat {final_loss}")
    if set(result.test_loss) != {"test_loss_pixel", "test_loss_kl_divergence"} or not all(
        value.shape == (RECON_HELIOSTATS,) and np.isfinite(value).all() for value in result.test_loss.values()
    ):
        raise AssertionError(f"phase 12 {label}: test losses {result.test_loss}")
    group = reconstructor.scenario.heliostat_groups[0]
    if not bool((group.nurbs_control_points != original).any()):
        raise AssertionError(f"phase 12 {label}: the control points did not move")
    points, normals = evaluate_nurbs_surfaces(
        group.nurbs_control_points,
        group.nurbs_degrees,
        create_nurbs_evaluation_grid(RECON_SURFACE_POINTS, device=original.device),
        canting=group.canting,
        facet_translations=group.facet_translations,
    )
    if not (torch.equal(group.surface_points, points.reshape(RECON_HELIOSTATS, -1, 4))
            and torch.equal(group.surface_normals, normals.reshape(RECON_HELIOSTATS, -1, 4))):
        raise AssertionError(f"phase 12 {label}: the surfaces are not those of the new control points")


def drive_surface_reconstruction(device: torch.device) -> dict:
    """Phase 12: ``SurfaceReconstructor.reconstruct_surfaces`` at bench.py's production
    configuration; one warm-up call, then a call of 2 and one of 6 epochs, whose
    slope is the seconds per epoch (bench.py:665-669): the fixed costs (data,
    batches, reference integrals, the final refresh) cancel, and the slope holds a
    quarter of one validation an epoch (2 against 3). Each call's launch counts
    are asserted; the long call's are the path's."""
    runs = {}
    for label, max_epoch in (("warm-up", RECON_EPOCHS[0]), ("short", RECON_EPOCHS[0]), ("long", RECON_EPOCHS[1])):
        reconstructor = surface_reconstructor(device, max_epoch)
        original = reconstructor.scenario.heliostat_groups[0].nurbs_control_points.clone()
        epoch_ends = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        start = time.perf_counter()
        final_loss, (result,) = reconstructor.reconstruct_surfaces(
            "kl_divergence", on_epoch=lambda epoch, loss: epoch_ends.append(time.perf_counter())
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = launch_counts()
        if counts != reconstruction_launches(max_epoch):
            raise AssertionError(
                f"phase 12 {label} launched {counts}, expected {reconstruction_launches(max_epoch)}"
            )
        check_reconstruction(label, reconstructor, original, final_loss, result, max_epoch)
        runs[label] = dict(
            seconds=seconds,
            epoch_seconds=np.diff([start] + epoch_ends).tolist(),
            launches=counts,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            history=result.loss_history,
            test_loss={key: value.tolist() for key, value in result.test_loss.items()},
        )
        del reconstructor
        torch.cuda.empty_cache()
    seconds_per_epoch = (runs["long"]["seconds"] - runs["short"]["seconds"]) / (RECON_EPOCHS[1] - RECON_EPOCHS[0])
    points = 4 * RECON_SURFACE_POINTS[0] * RECON_SURFACE_POINTS[1]
    train_samples = RECON_HELIOSTATS * (RECON_SAMPLES - 1)
    train_rays = train_samples * RECON_RAYS * points
    result = dict(
        launches=runs["long"]["launches"],
        seconds_per_epoch=seconds_per_epoch,
        train_rays_per_epoch=train_rays,
        validation_rays=RECON_HELIOSTATS * RECON_RAYS * points,
        rays_per_second=train_rays / seconds_per_epoch,
        max_memory_allocated=max(run["max_memory_allocated"] for run in runs.values()),
        runs=runs,
    )
    for label, run in runs.items():
        _log(
            f"phase 12 surface reconstructor, {label} call: {len(run['epoch_seconds'])} epochs in "
            f"{run['seconds']:.6f} s, epoch ends after {run['epoch_seconds']} s, max_memory_allocated "
            f"{run['max_memory_allocated']} B, launches {run['launches']}, history {json.dumps(run['history'])}, "
            f"test losses {json.dumps(run['test_loss'])}"
        )
    _log(
        f"phase 12 surface reconstructor: {seconds_per_epoch:.6f} s an epoch (slope of {RECON_EPOCHS[1] + 1} "
        f"against {RECON_EPOCHS[0] + 1} epochs), {train_rays} train rays an epoch ({train_samples} samples), "
        f"{result['rays_per_second']:.6g} rays/s, max_memory_allocated {result['max_memory_allocated']} B"
    )
    if not seconds_per_epoch > 0:
        raise AssertionError(f"phase 12: non-positive seconds per epoch {seconds_per_epoch}")
    return result


# Phase 7d's small reconstructor: 4 heliostats x 2 samples (1 train, 1 test), 8 x 8
# points a facet, 8 rays, 64 x 64 bitmaps, ray chunks of 4, 3 epochs, at rates of
# 1e-5 to 3e-5: large enough for the ideal-surface regularizer's squared
# displacements to dwarf its 1e-12 epsilon, small enough that Adam's +-lr steps on
# gradient entries at rounding level move the losses by less than 1e-5. The
# measured flux is ones on each sample's cropped spot (above 5% of its peak, on
# the CPU at the start) and zeros off it, as phase 7a's ground truth: under the
# synthetic parser's Gaussians, positive on every pixel, the KL term -p log q of a
# rim pixel holding a sliver of one deposit turned rounding into 4.4e-4 of the
# loss between the card and the CPU at one epoch (1e-5 on the others).
SMALL_RECONSTRUCTION = dict(heliostats=4, samples=2, surface_points=(8, 8), rays=8, bitmap=(64, 64), ray_chunk=4)
SMALL_RECONSTRUCTION_EPOCHS = 2  # max_epoch: 3 epochs
SMALL_RECONSTRUCTION_RATES = dict(lr_min=1e-5, lr_max=3e-5, step_size_up=2)
# The histories' tolerances: phase 7a's loss rtol, 1e-4 of the total loss, for
# the loss and each of its parts; the mean relative flux-integral difference
# (near 0) to 1e-4 absolute, the energy-constraint term, a function of it below
# 1e-3, to 1e-5.
HISTORY_ABSOLUTE = {"flux_integral": 1e-4, "flux_integral_constraint": 1e-5}


class MeasuredFlux:
    """A calibration parser whose samples measure the given flux ``[S, H, W]``
    (numpy), the rest of each sample from ``parser``."""

    def __init__(self, parser, flux: np.ndarray):
        self.parser, self.flux = parser, flux

    def parse_data_for_reconstruction(self, **kwargs):
        data = self.parser.parse_data_for_reconstruction(**kwargs)
        return dataclasses.replace(data, flux_measured=self.flux)


def small_reconstructor(device: torch.device, distortions, flux: np.ndarray | None = None) -> SurfaceReconstructor:
    """The small reconstructor on ``device``, its light source handing out
    ``distortions`` (the train and the test batch's), measuring ``flux`` if given."""
    size = SMALL_RECONSTRUCTION
    reconstructor = surface_reconstructor(
        device, SMALL_RECONSTRUCTION_EPOCHS, size["heliostats"], size["surface_points"], size["rays"], size["bitmap"],
        size["ray_chunk"], size["samples"],
        reconstruction_configuration(SMALL_RECONSTRUCTION_EPOCHS, **SMALL_RECONSTRUCTION_RATES),
    )
    reconstructor.scenario.light_sources[0] = QueuedDistortions(size["rays"], distortions)
    if flux is not None:
        reconstructor.data[constants.data_parser] = MeasuredFlux(reconstructor.data[constants.data_parser], flux)
    return reconstructor


def spot_ground_truth(distortions) -> np.ndarray:
    """Ones where each sample's cropped flux at the start exceeds 5% of its peak, on
    the CPU, in the samples' order."""
    reconstructor = small_reconstructor(torch.device("cpu"), list(distortions))
    group = reconstructor.scenario.heliostat_groups[0]
    unique, split = training.group_calibration_split(
        reconstructor.data, reconstructor.scenario, group, reconstructor.bitmap_resolution
    )
    samples = split.train_indices.size + split.test_indices.size
    flux = np.zeros((samples,) + split.flux_measured_train.shape[1:], np.float32)
    for batch, index in zip(reconstructor._batches(group, split, unique), (split.train_indices, split.test_indices)):
        inputs = batch_inputs(reconstructor, batch)
        with torch.no_grad():
            cropped = crop_flux_distributions_around_center(
                render(group.nurbs_control_points, inputs)[0], reconstructor.scenario.solar_tower,
                inputs.target_area_indices,
            )
        flux[index] = (cropped > 0.05 * cropped.amax(dim=(1, 2), keepdim=True)).float().numpy()
    return flux


def check_small_reconstruction_against_cpu(device: torch.device) -> dict:
    """Phase 7d: the small reconstructor's loss histories, ``device`` against the CPU,
    from the same distortions; on the card with its launch counts asserted."""
    size = SMALL_RECONSTRUCTION
    rng = np.random.RandomState(SEED + 6)
    points = 4 * size["surface_points"][0] * size["surface_points"][1]
    samples = size["heliostats"]  # one train and one test sample a heliostat
    distortions = [
        tuple(rng.normal(0.0, 2e-3, (2, samples, size["rays"], points)).astype(np.float32)) for _ in range(2)
    ]
    spot = spot_ground_truth(distortions)
    on_device = small_reconstructor(device, list(distortions), spot)
    reset_launch_counts()
    card = on_device.reconstruct_surfaces("kl_divergence")[1][0]
    counts = launch_counts()
    cpu = small_reconstructor(torch.device("cpu"), list(distortions), spot).reconstruct_surfaces("kl_divergence")[1][0]
    expected = reconstruction_launches(SMALL_RECONSTRUCTION_EPOCHS, size["rays"] // size["ray_chunk"])
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"phase 7d small reconstructor launched {counts}, expected {expected}")
    errors = {}
    total = float(np.abs(cpu.loss_history["total_loss"]).max())
    for key, values in cpu.loss_history.items():
        mine, other = np.asarray(card.loss_history[key]), np.asarray(values)
        if mine.shape != (SMALL_RECONSTRUCTION_EPOCHS + 1,) or mine.shape != other.shape:
            raise AssertionError(f"phase 7d: history {key} {mine} on {device}, {other} on cpu")
        err = float(np.abs(mine - other).max())
        limit = HISTORY_ABSOLUTE.get(key, 1e-4 * total)
        if not err <= limit:
            raise AssertionError(f"phase 7d: history {key} differs between {device} and cpu: {mine} vs {other}")
        errors[key] = (err, limit)
    test_err = max(
        float(np.abs(card.test_loss[key] - value).max() / np.abs(value).max()) for key, value in cpu.test_loss.items()
    )
    _log(
        f"phase 7d agreement: small reconstructor on {device} vs cpu: total loss {card.loss_history['total_loss']} vs "
        f"{cpu.loss_history['total_loss']}; "
        + ", ".join(f"{key} max err {err:.3g} ({err / limit:.3g} of its limit)" for key, (err, limit) in errors.items())
        + f"; test losses max rel err {test_err:.3g}; launches {counts}"
    )
    return errors


def mixed_tower(device: torch.device) -> SolarTower:
    """The synthetic field's 10 x 10 m receiver at 45 m and a cylinder of radius 10 m
    at 30 m, 3 m high, 0.4 rad open toward the field (a 4 m arc; no ray grazes it)."""

    def tensor(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return SolarTower(
        planar_centers=tensor([[0.0, -3.0, 45.0, 1.0]]),
        planar_normals=tensor([[0.0, 1.0, 0.0, 0.0]]),
        planar_dimensions=tensor([[10.0, 10.0]]),
        cylindrical_centers=tensor([[0.0, -13.0, 30.0, 1.0]]),
        cylindrical_axes=tensor([[0.0, 0.0, 1.0, 0.0]]),
        cylindrical_normals=tensor([[0.0, 1.0, 0.0, 0.0]]),
        cylindrical_radii=tensor([10.0]),
        cylindrical_heights=tensor([3.0]),
        cylindrical_opening_angles=tensor([0.4]),
        planar_names=("receiver",),
        cylindrical_names=("cylinder",),
    )


SMALL_MIXED = dict(heliostats=3, surface_points=(5, 5), rays=4, bitmap=(48, 40), ray_chunk=2)
# Card against CPU on the mixed tower: the flux to 2e-4 of its peak, where a hit on
# the cylinder solves a quadratic that cancels b^2 against 4ac, so that rounding a
# direction differently moves a hit by up to 2.5e-4 px (tests/test_torch_cylinder.py);
# the factors, ray counts, to 1e-6.
MIXED_FLUX_TOLERANCE = 2e-4


def small_mixed_trace(device: torch.device, distortions: np.ndarray):
    """The trace of the small field onto the mixed tower, heliostats 0 and 2 aiming at
    the receiver and 1 at the cylinder: flux and factors."""
    size = SMALL_MIXED
    scenario = make_synthetic_scenario(
        number_of_heliostats=size["heliostats"], number_of_surface_points_per_facet=size["surface_points"],
        number_of_rays=size["rays"], device=device,
    )
    tower = mixed_tower(device)
    num = size["heliostats"]
    targets = torch.tensor([0, 1, 0], device=device)
    incident = torch.tensor([0.0, 1.0, 0.0, 0.0], device=device).expand(num, 4)
    active = hg.gather_active(scenario.heliostat_groups[0], torch.arange(num, device=device))
    with torch.no_grad():
        points, normals = hg.align_surfaces_with_incident_ray_directions(
            active, get_centers_of_target_areas(tower, targets), incident
        )[:2]
        du, de = (torch.tensor(x, device=device) for x in distortions)
        config = RenderConfig(bitmap_resolution=size["bitmap"], ray_chunk=size["ray_chunk"])
        return [x.cpu() for x in trace_rays(tower, points, normals, incident, targets, du, de, config=config)]


def check_small_mixed_trace_against_cpu(device: torch.device) -> None:
    """Phase 7d: the small trace onto the planar and cylindrical tower, ``device``
    against the CPU."""
    size = SMALL_MIXED
    points = 4 * size["surface_points"][0] * size["surface_points"][1]
    distortions = np.random.RandomState(SEED + 7).normal(
        0.0, 1e-2, (2, size["heliostats"], size["rays"], points)
    ).astype(np.float32)
    reset_launch_counts()
    card = small_mixed_trace(device, distortions)
    counts = launch_counts()
    cpu = small_mixed_trace(torch.device("cpu"), distortions)
    peak = float(cpu[0].max())
    flux_err = float((card[0] - cpu[0]).abs().max())
    factor_err = max(float((a - b).abs().max()) for a, b in zip(card[1:], cpu[1:]))
    lit = cpu[0].sum(dim=(1, 2))
    if not (flux_err <= MIXED_FLUX_TOLERANCE * peak and factor_err <= 1e-6 and bool((lit > 0).all())):
        raise AssertionError(
            f"phase 7d mixed tower: flux max err {flux_err} (peak {peak}), factors max err {factor_err}, "
            f"map sums {lit.tolist()}"
        )
    chunks = size["rays"] // size["ray_chunk"]
    if device.type == "cuda" and counts != launches(splat_forward=chunks):
        raise AssertionError(f"phase 7d mixed tower launched {counts}")
    _log(
        f"phase 7d agreement: trace onto a planar and a cylindrical target area on {device} vs cpu: flux max err "
        f"{flux_err:.3g} ({flux_err / (MIXED_FLUX_TOLERANCE * peak):.3g} of its limit), factors max err "
        f"{factor_err:.3g}, intercept factors {card[1].tolist()}; launches {counts}"
    )


# --------------------------------------------------------------------------- #
# The kinematics reconstructor (phase 13).
# --------------------------------------------------------------------------- #

# The production calibration (examples/field_optimizations/config.yaml:56-70: the
# alignment method, 20 samples a heliostat, 19 rays a point) on the synthetic field:
# 100 heliostats x 20 samples (15 train, 5 test), 50 x 50 points a facet x 4 facets,
# 256 x 256 maps. A validation traces 500 x 190,000 rays (95 M); the flux-driven
# method's train epoch 1,500 x 190,000 (285 M), forward and backward, in one call.
KINEMATICS = dict(heliostats=100, samples=20, surface_points=(50, 50), rays=19, bitmap=(256, 256))
# Phase 13b's field (the flux-driven method at the same size).
KINEMATICS_FLUX = dict(KINEMATICS)
# The timed calls' max_epoch, short and long. The alignment method's long call runs
# the configuration's 500, where the early stopping (a window of 40 epochs that must
# improve by more than 100%, which no window of positive losses does, and patience 10)
# ends every run at epoch 48: the slope is taken over the epochs each call ran, with
# the same two validations (epoch 0, and epoch 19 or the stop) in both calls. The
# flux-driven calls run 3 and 21 epochs, also with two validations each (epochs 0 and 1,
# 0 and 19): an epoch takes ~35 ms on an H100 with the ray kernels, so the slope needs
# the long call's 18 more epochs to stand clear of each call's ~0.6 s preamble, which
# moves by tens of ms from call to call.
KINEMATICS_EPOCHS = (20, 500)
KINEMATICS_FLUX_EPOCHS = (2, 20)
KINEMATICS_DATA_CHUNK = 250  # samples traced at once while the calibration data are built
# The known rotation deviations: random signs, magnitudes in this range (rad).
KNOWN_DEVIATIONS = (4e-3, 8e-3)


def kinematics_configuration(max_epoch: int) -> dict:
    """The production calibration's optimizer (config.yaml:56-70) with ``max_epoch``:
    initial rate 3e-4, tolerance 5e-4, log step 50, reduce-on-plateau (minimum 1e-6,
    factor 0.8, patience 50, threshold 1e-3, cooldown 5), early stopping (delta 1.0,
    patience 10, window 40); ``batch_size`` 480 is passed and not read."""
    return {
        constants.optimization: {
            constants.initial_learning_rate_rotation_deviation: 3e-4,
            constants.tolerance: 5e-4,
            constants.max_epoch: max_epoch,
            constants.batch_size: 480,
            constants.log_step: 50,
            constants.early_stopping_delta: 1.0,
            constants.early_stopping_patience: 10,
            constants.early_stopping_window: 40,
        },
        constants.scheduler: {
            constants.scheduler_type: constants.reduce_on_plateau,
            constants.lr_min: 1e-6,
            constants.reduce_factor: 0.8,
            constants.patience: 50,
            constants.threshold: 1e-3,
            constants.cooldown: 5,
        },
    }


class CalibrationSamples(CalibrationDataParser):
    """A calibration parser over the given ``CalibrationData`` of a synthetic field's
    heliostats ``H0000``, ``H0001``, ... (each heliostat's samples consecutive): a
    group gets its own heliostats' samples, found by name (the whole data for the
    whole field), so a field split into groups reads the same samples; with
    ``sample_limit``, each heliostat's first ``sample_limit``."""

    def __init__(self, data: CalibrationData, sample_limit: int | None = None):
        names = tuple(f"H{i:04d}" for i in range(len(data.active_heliostats_mask)))
        super().__init__(data, names, sample_limit)


def known_rotation_deviations(heliostats: int, seed: int = SEED + 11, magnitudes=KNOWN_DEVIATIONS) -> np.ndarray:
    """``[H, 4]`` rotation deviations with random signs and magnitudes in ``magnitudes`` (rad)."""
    rng = np.random.RandomState(seed)
    signs = np.where(rng.rand(heliostats, 4) < 0.5, -1.0, 1.0)
    return (signs * rng.uniform(*magnitudes, (heliostats, 4))).astype(np.float32)


def sun_directions(count: int, seed: int) -> np.ndarray:
    """``[count, 4]`` incident ray directions from distinct sun positions south of the
    field (azimuth -60 to 60 degrees from south, elevation 15 to 65 degrees)."""
    rng = np.random.RandomState(seed)
    sun = azimuth_elevation_to_enu(rng.uniform(-60.0, 60.0, count), rng.uniform(15.0, 65.0, count))
    return convert_3d_directions_to_4d_format(-sun).numpy()


@torch.no_grad()
def kinematics_calibration(scenario, deviations: np.ndarray, samples: int, bitmap: tuple[int, int],
                           seed: int = SEED + 12, chunk: int = KINEMATICS_DATA_CHUNK) -> CalibrationData:
    """Calibration samples that identify rotation deviations: ``samples`` a heliostat of
    the scenario's first group (whose deviations are 0), each under its own sun
    (:func:`sun_directions`); motor positions that aim the ideal heliostat at the
    target's centre; the flux the heliostat casts with the rotation deviations
    ``deviations`` ``[H, 4]`` at those motor positions (traced ``chunk`` samples at a
    time, on the scenario's device); the focal spot at that flux's centre of mass on
    the target."""
    group = scenario.heliostat_groups[0]
    tower = scenario.solar_tower
    device = group.positions.device
    total = group.number_of_heliostats * samples
    heliostat = torch.arange(group.number_of_heliostats, device=device).repeat_interleave(samples)
    incident = torch.tensor(sun_directions(total, seed), device=device)
    targets = torch.zeros(total, dtype=torch.long, device=device)
    aim_points = get_centers_of_target_areas(tower, targets)
    deviated = group.replace(rotation_deviations=torch.tensor(deviations, device=device))
    generator = torch.Generator(device=device).manual_seed(seed)
    sun = scenario.light_sources[0]
    motors, flux = [], []
    for start in range(0, total, chunk):
        part = slice(start, start + chunk)
        index = heliostat[part]
        motor = hg.align_surfaces_with_incident_ray_directions(
            hg.gather_active(group, index), aim_points[part], incident[part]
        )[3]
        points, normals, _ = hg.align_surfaces_with_motor_positions(hg.gather_active(deviated, index), motor)
        distortions_u, distortions_e = sun.get_distortions(generator, points.shape[1], index.shape[0])
        flux.append(
            trace_rays(
                tower, points, normals, incident[part], targets[part], distortions_u, distortions_e,
                config=RenderConfig(bitmap_resolution=bitmap),
            )[0]
        )
        motors.append(motor)
    flux = torch.cat(flux)
    spots = bitmap_coordinates_to_target_coordinates(get_center_of_mass(flux), bitmap, tower, targets)
    return CalibrationData(
        flux_measured=flux.cpu().numpy(),
        focal_spots=spots.cpu().numpy(),
        incident_ray_directions=incident.cpu().numpy(),
        motor_positions=torch.cat(motors).cpu().numpy(),
        active_heliostats_mask=np.full(group.number_of_heliostats, samples, np.int32),
        target_area_indices=np.zeros(total, np.int32),
    )


def kinematics_scenario(device: torch.device, size: dict):
    return make_synthetic_scenario(
        number_of_heliostats=size["heliostats"],
        number_of_surface_points_per_facet=size["surface_points"],
        number_of_rays=size["rays"],
        device=device,
    )


def kinematics_reconstructor(device: torch.device, size: dict, data: CalibrationData, method: str,
                             configuration: dict, **options) -> KinematicsReconstructor:
    """A ``KinematicsReconstructor`` with ``method`` on a fresh synthetic field (rotation
    deviations 0) of ``size``, reading the calibration samples ``data``."""
    return KinematicsReconstructor(
        scenario=kinematics_scenario(device, size),
        data={constants.data_parser: CalibrationSamples(data), constants.heliostat_data_mapping: []},
        optimization_configuration=configuration,
        reconstruction_method=method,
        bitmap_resolution=size["bitmap"],
        seed=SEED,
        **options,
    )


def kinematics_launches(method: str, epochs: list[int], max_epoch: int, log_step: int, stopped: bool) -> dict:
    """The launches of one ``reconstruct_kinematics`` call that ran ``epochs``: a
    validation (one splat forward) where ``epoch % log_step == 0``, at epoch
    ``max_epoch - 1`` and at an early stop; with the flux-driven method, one splat
    forward and one backward each epoch."""
    train = len(epochs) if method == constants.kinematics_reconstruction_raytracing else 0
    return launches(splat_forward=train + validations(epochs, max_epoch, log_step, stopped), splat_backward=train)


def run_kinematics(device: torch.device, size: dict, data: CalibrationData, method: str, max_epoch: int,
                   known: np.ndarray, label: str) -> dict:
    """One timed ``reconstruct_kinematics`` call on a fresh field, its launches asserted
    against :func:`kinematics_launches`; its losses, history and the distance of the
    rotation deviations from ``known`` before and after."""
    configuration = kinematics_configuration(max_epoch)
    reconstructor = kinematics_reconstructor(device, size, data, method, configuration)
    epochs, epoch_ends = [], []

    def on_epoch(epoch: int, loss: float) -> None:
        epochs.append(epoch)
        epoch_ends.append(time.perf_counter())

    synchronize(device)
    reset_peak_memory(device)
    reset_launch_counts()
    start = time.perf_counter()
    final_loss, (result,) = reconstructor.reconstruct_kinematics(on_epoch=on_epoch)
    synchronize(device)
    seconds = time.perf_counter() - start
    counts = launch_counts()
    stopped = len(result.loss_history) == len(epochs) - 1
    log_step = configuration[constants.optimization][constants.log_step]
    expected = kinematics_launches(method, epochs, max_epoch, log_step, stopped)
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"phase 13 {label} launched {counts}, expected {expected}")
    # The planar tower without blocking: every trace runs the ray pair beside the splat's.
    expected_rays = ray_launches(expected["splat_forward"], expected["splat_backward"])
    if device.type == "cuda" and ray_kernels.LAUNCHES != expected_rays:
        raise AssertionError(f"phase 13 {label} launched {ray_kernels.LAUNCHES}, expected {expected_rays}")
    history = result.loss_history
    if not history or not np.isfinite(history).all() or not np.isfinite(final_loss).all():
        raise AssertionError(f"phase 13 {label}: history {history}, final losses {final_loss}")
    if set(result.test_loss) != set(VALIDATION_LOSSES) or not all(
        np.isfinite(value).all() for value in result.test_loss.values()
    ):
        raise AssertionError(f"phase 13 {label}: test losses {result.test_loss}")
    deviations = reconstructor.scenario.heliostat_groups[0].rotation_deviations.cpu().numpy()
    return dict(
        seconds=seconds,
        epochs=len(epochs),
        stopped=stopped,
        epoch_seconds=np.diff([start] + epoch_ends).tolist(),
        launches=counts,
        max_memory_allocated=max_memory(device),
        history=history,
        test_loss={key: float(value.mean()) for key, value in result.test_loss.items()},
        distance_before=float(np.linalg.norm(known)),
        distance_after=float(np.linalg.norm(deviations - known)),
    )


def drive_kinematics(device: torch.device, method: str, size: dict, epochs: tuple[int, int], phase: str,
                     data: CalibrationData, known: np.ndarray) -> dict:
    """A warm-up call, then a short and a long timed call of ``reconstruct_kinematics``;
    the seconds per epoch are the slope between the two over the epochs they ran."""
    runs = {
        label: run_kinematics(device, size, data, method, max_epoch, known, f"{phase} {label}")
        for label, max_epoch in (("warm-up", 1), ("short", epochs[0]), ("long", epochs[1]))
    }
    short, long = runs["short"], runs["long"]
    if long["epochs"] <= short["epochs"]:
        raise AssertionError(f"{phase}: the long call ran {long['epochs']} epochs, the short {short['epochs']}")
    seconds_per_epoch = (long["seconds"] - short["seconds"]) / (long["epochs"] - short["epochs"])
    for label, run in runs.items():
        _log(
            f"{phase}, {label} call: {run['epochs']} epochs{' (early stop)' if run['stopped'] else ''} in "
            f"{run['seconds']:.6f} s, max_memory_allocated {run['max_memory_allocated']} B, launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }, loss {run['history'][0]} -> {run['history'][-1]}, "
            f"test losses {json.dumps(run['test_loss'])}, |deviations - known| {run['distance_before']:.6g} -> "
            f"{run['distance_after']:.6g}"
        )
    if device.type == "cuda" and not seconds_per_epoch > 0:
        raise AssertionError(f"{phase}: non-positive seconds per epoch {seconds_per_epoch}")
    memory = [run["max_memory_allocated"] for run in runs.values()]
    return dict(
        launches=long["launches"],
        seconds_per_epoch=seconds_per_epoch,
        max_memory_allocated=None if None in memory else max(memory),
        runs=runs,
    )


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def max_memory(device: torch.device) -> int | None:
    """``torch.cuda.max_memory_allocated`` on the card; None elsewhere."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def empty_cache(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def kinematics_rays(reconstructor: KinematicsReconstructor, batch: dict):
    """The splat's inputs of a flux-driven batch, as its trace makes them: ``[S, R * P]`` each."""
    group = reconstructor.scenario.heliostat_groups[0]
    with torch.no_grad():
        points, normals, _ = hg.align_surfaces_with_motor_positions(
            reconstructor._active(group.rotation_deviations, batch), batch["motor_positions"]
        )
        rays = ray_splat_inputs(
            reconstructor.scenario.solar_tower,
            geometry.reflect(batch["incident_ray_directions"][:, None, :], normals),
            points,
            batch["target_area_indices"],
            batch["distortions_u"],
            batch["distortions_e"],
            batch["ray_magnitude"],
            RenderConfig(bitmap_resolution=reconstructor.bitmap_resolution),
        )
    num = points.shape[0]
    return tuple(x.reshape(num, -1).contiguous() for x in (rays.bitmap_e, rays.bitmap_u, rays.final_intensities))


def check_kinematics_kernels(device: torch.device, size: dict, data: CalibrationData) -> dict[str, dict]:
    """Phase 13b's kernel check: row 1 at the validation batch's rays and rows 1 and 2 at
    the flux-driven train batch's, each against its plain version, then timed beside
    ``index_add_`` and the bound. Returns the timings, by kernel and shape."""
    reconstructor = kinematics_reconstructor(
        device, size, data, constants.kinematics_reconstruction_raytracing, kinematics_configuration(0)
    )
    return check_reconstructor_batches(
        reconstructor, "phase 13b", "kinematics_train", "kinematics_validation", SEED + 13
    )


def reconstructor_batches(reconstructor: KinematicsReconstructor) -> tuple[dict, dict]:
    """A reconstructor's train and validation batches of its first group."""
    group = reconstructor.scenario.heliostat_groups[0]
    unique, split = training.group_calibration_split(
        reconstructor.data, reconstructor.scenario, group, reconstructor.bitmap_resolution
    )
    train, validation = reconstructor._batches(group, split, unique)
    return train, validation


def check_reconstructor_batches(reconstructor: KinematicsReconstructor, phase: str, train_key: str,
                                validation_key: str, seed: int) -> dict[str, dict]:
    """The splat pair at a flux-driven reconstructor's batches: row 1 at the validation
    batch's rays and rows 1 and 2 at the train batch's, each against its plain version
    (the backward on a cotangent drawn from ``seed``), then timed beside ``index_add_``
    and the bound. Returns the timings by kernel, under ``train_key`` and
    ``validation_key``."""
    width, height = reconstructor.bitmap_resolution
    device = reconstructor.device
    batches = dict(zip((train_key, validation_key), reconstructor_batches(reconstructor)))
    timings: dict[str, dict] = {"splat_forward": {}, "splat_backward": {}}
    for label in (validation_key, train_key):
        rays = kinematics_rays(reconstructor, batches.pop(label))
        shape = list(rays[0].shape)
        forward_err, share = check_forward(
            "splat_forward", splat_forward_cuda(*rays, height, width), splat_forward_plain(*rays, height, width),
            rays, height, width,
        )
        g = None
        if label == train_key:
            g = torch.randn(
                (shape[0], height, width), device=device, generator=torch.Generator(device=device).manual_seed(seed)
            )
            backward_errs, backward_share = check_backward(
                "splat_backward", splat_backward_cuda(*rays, g, height, width),
                splat_backward_plain(*rays, g, height, width), rays[2], g,
            )
            share = max(share, backward_share)
        timed, work = time_splat_pair(rays, g, height, width, iterations=5)
        timed["splat_forward"]["max_abs_err"] = forward_err
        if g is not None:
            timed["splat_backward"]["max_abs_err"] = max(backward_errs)
        _log(
            f"{phase} splat kernels at the flux-driven {'train' if label == train_key else 'validation'} batch: "
            f"{shape} rays ({work['valid']} valid, {work['touched']} pixels touched) -> "
            f"[{shape[0]}, {height}, {width}]; worst error {share:.3g} of its tolerance: "
            + "; ".join(
                f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"library {t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} ms, "
                + describe_bound(t)
                for name, t in timed.items()
            )
        )
        del work, rays, g
        for name, t in timed.items():
            timings[name][label] = dict(
                shape=shape, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1], max_abs_err=t["max_abs_err"],
            )
        empty_cache(device)
    return timings


def drive_kinematics_alignment(device: torch.device, size: dict = KINEMATICS,
                               epochs: tuple[int, int] = KINEMATICS_EPOCHS) -> tuple[dict, CalibrationData, np.ndarray]:
    """Phase 13a: the alignment method at the production calibration on calibration
    samples built from known rotation deviations. Returns the path's result, the
    samples and the deviations."""
    phase = "phase 13a kinematics reconstructor (alignment)"
    known = known_rotation_deviations(size["heliostats"])
    start = time.perf_counter()
    data = kinematics_calibration(kinematics_scenario(device, size), known, size["samples"], size["bitmap"])
    _log(f"{phase}: {data.flux_measured.shape[0]} calibration samples built in {time.perf_counter() - start:.3f} s")
    result = drive_kinematics(device, constants.kinematics_reconstruction_alignment, size, epochs, phase, data, known)
    long = result["runs"]["long"]
    if not (long["history"][-1] < long["history"][0] and long["distance_after"] < long["distance_before"]):
        raise AssertionError(
            f"{phase}: loss {long['history'][0]} -> {long['history'][-1]}, |deviations - known| "
            f"{long['distance_before']} -> {long['distance_after']}"
        )
    _log(
        f"{phase}: {result['seconds_per_epoch']:.6f} s an epoch (slope of {long['epochs']} against "
        f"{result['runs']['short']['epochs']} epochs), max_memory_allocated {result['max_memory_allocated']} B"
    )
    return result, data, known


def flux_driven_samples(device: torch.device, data: CalibrationData, known: np.ndarray,
                        size: dict = KINEMATICS_FLUX) -> tuple[CalibrationData, np.ndarray]:
    """Phase 13a's samples and deviations, or, where phase 13b's field is cut, samples
    built alike for a field of ``size["heliostats"]`` (whose layout differs)."""
    if len(data.active_heliostats_mask) == size["heliostats"]:
        return data, known
    known = known_rotation_deviations(size["heliostats"])
    return kinematics_calibration(kinematics_scenario(device, size), known, size["samples"], size["bitmap"]), known


def drive_kinematics_raytracing(device: torch.device, data: CalibrationData, known: np.ndarray,
                                size: dict = KINEMATICS_FLUX,
                                epochs: tuple[int, int] = KINEMATICS_FLUX_EPOCHS) -> dict:
    """Phase 13b: the flux-driven method on samples of ``size`` (:func:`flux_driven_samples`):
    its timed calls, then one scrubbed objective gradient, which must be finite and
    not all zero."""
    phase = "phase 13b kinematics reconstructor (raytracing)"
    result = drive_kinematics(device, constants.kinematics_reconstruction_raytracing, size, epochs, phase, data, known)
    empty_cache(device)
    gradients = kinematics_reconstructor(
        device, size, data, constants.kinematics_reconstruction_raytracing, kinematics_configuration(0)
    ).single_step_gradients()[0]["gradients"]
    if not (np.isfinite(gradients).all() and (gradients != 0).any()):
        raise AssertionError(f"{phase}: scrubbed gradient {gradients}")
    result["gradient_max_abs"] = float(np.abs(gradients).max())
    _log(
        f"{phase}: {result['seconds_per_epoch']:.6f} s an epoch (slope of {result['runs']['long']['epochs']} against "
        f"{result['runs']['short']['epochs']} epochs), max_memory_allocated {result['max_memory_allocated']} B, "
        f"scrubbed gradient max |g| {result['gradient_max_abs']:.6g}"
    )
    return result


# Phase 13c: a small kinematics loop (alignment, the production optimizer) and a
# small aim-point loop, each run straight through 6 epochs and as a run of 4
# epochs that saves every 2 and stops, then a run of 6 that resumes from its epoch
# 2. On the card the kinematics loop runs under torch's deterministic algorithms
# (its gradient's index_add_ sums a heliostat's samples in a fixed order) and must
# equal the straight run bit for bit. The aim-point loop's splat forward (row 1)
# adds a pixel's deposits with shared-memory atomics in an order that may change
# from run to run, so on the card it agrees within RESUME_TOLERANCE. Two straight
# runs that happen to agree bit for bit do not show that the order held: on an
# H100 80GB HBM3 (700 W limit) any two of these runs either agreed or parted by
# 1.5224354748964094e-06 (relative), in no fixed pattern. Every loop, on every device,
# must also give back bit for bit the history up to its checkpoint: the resumed
# run's first RESUME_EVERY + 1 entries are the stopped run's.
SMALL_KINEMATICS = dict(heliostats=4, samples=4, surface_points=(5, 5), rays=4, bitmap=(64, 64))
SMALL_RESUME_AIM = dict(heliostats=4, surface_points=(5, 5), rays=4, bitmap=(64, 64))
RESUME_EPOCHS = (3, 5)  # max_epoch of the run that stops and of the others
RESUME_EVERY = 2
RESUME_TOLERANCE = 1e-4  # relative, for runs on the card whose straight runs differ


def resumed_runs(run) -> dict[str, tuple[np.ndarray, ...]]:
    """``run(checkpoint_dir, max_epoch)`` -> (loss history, parameters...): straight
    through twice, then stopped after a checkpoint and resumed from it."""
    with tempfile.TemporaryDirectory() as root:
        root = pathlib.Path(root)
        straight = run(root / "straight", RESUME_EPOCHS[1])
        again = run(root / "again", RESUME_EPOCHS[1])
        stopped = run(root / "resumed", RESUME_EPOCHS[0])
        resumed = run(root / "resumed", RESUME_EPOCHS[1])
    return dict(straight=straight, again=again, stopped=stopped, resumed=resumed)


def compare_resumed(label: str, runs: dict, exact: bool) -> dict:
    """The resumed run against the straight one: bit for bit where ``exact``, otherwise
    within RESUME_TOLERANCE; and its history up to the checkpoint bit for bit the
    stopped run's."""
    def largest_gap(a, b) -> float:
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max() / max(np.abs(np.asarray(y)).max(), 1e-30))
                   for x, y in zip(a, b))

    straight, again, stopped, resumed = runs["straight"], runs["again"], runs["stopped"], runs["resumed"]
    if len(resumed[0]) != RESUME_EPOCHS[1] + 1 or len(straight[0]) != RESUME_EPOCHS[1] + 1:
        raise AssertionError(f"phase 13c {label}: histories {straight[0]} and {resumed[0]}")
    restored = RESUME_EPOCHS[0] // RESUME_EVERY * RESUME_EVERY + 1  # entries up to the checkpoint
    if len(stopped[0]) != RESUME_EPOCHS[0] + 1 or not np.array_equal(resumed[0][:restored], stopped[0][:restored]):
        raise AssertionError(
            f"phase 13c {label}: the resumed run's history {resumed[0]} does not begin with the stopped run's "
            f"first {restored} entries {stopped[0]}"
        )
    reproducible = all(np.array_equal(x, y) for x, y in zip(straight, again))
    equal = all(np.array_equal(x, y) for x, y in zip(straight, resumed))
    gap, spread = largest_gap(resumed, straight), largest_gap(again, straight)
    if exact and not equal:
        raise AssertionError(f"phase 13c {label}: the resumed run differs from the straight one by {gap} (relative)")
    if not gap <= RESUME_TOLERANCE:
        raise AssertionError(f"phase 13c {label}: the resumed run differs from the straight one by {gap} (relative)")
    return dict(bit_equal=equal, straight_runs_bit_equal=reproducible, relative_gap=gap, straight_spread=spread)


def check_resume(device: torch.device) -> dict:
    """Phase 13c: the kinematics and the aim-point loop resumed from a checkpoint on
    ``device`` against straight runs."""
    size = SMALL_KINEMATICS
    known = known_rotation_deviations(size["heliostats"])
    data = kinematics_calibration(kinematics_scenario(device, size), known, size["samples"], size["bitmap"])

    def kinematics_run(directory, max_epoch):
        reconstructor = kinematics_reconstructor(
            device, size, data, constants.kinematics_reconstruction_alignment, kinematics_configuration(max_epoch),
            checkpoint_dir=directory, checkpoint_every=RESUME_EVERY,
        )
        result = reconstructor.reconstruct_kinematics()[1][0]
        deviations = reconstructor.scenario.heliostat_groups[0].rotation_deviations
        return np.asarray(result.loss_history), deviations.cpu().numpy()

    aim = SMALL_RESUME_AIM
    ground_truth = aim_point_ground_truth(aim["bitmap"], device, slope=10, plateau=20)

    def aim_point_run(directory, max_epoch):
        scenario = aim_point_scenario(device, aim["heliostats"], aim["surface_points"], aim["rays"])
        optimizer = aim_point_optimizer(
            scenario, ground_truth, max_epoch, AIM_CANDIDATES, aim["bitmap"], checkpoint_dir=directory,
            checkpoint_every=RESUME_EVERY,
        )
        history = optimizer.optimize("kl_divergence")[1]
        motors = scenario.heliostat_groups[0].motor_positions.cpu().numpy()
        return np.asarray(history["total_loss"]), np.concatenate([np.asarray(v) for v in history.values()]), motors

    deterministic = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            kinematics = compare_resumed("kinematics", resumed_runs(kinematics_run), exact=True)
        finally:
            torch.use_deterministic_algorithms(deterministic)
    aim_point = compare_resumed("aim point", resumed_runs(aim_point_run), exact=device.type != "cuda")
    _log(f"phase 13c resume on {device}: kinematics {json.dumps(kinematics)}; aim point {json.dumps(aim_point)}")
    return dict(kinematics=kinematics, aim_point=aim_point)


# --------------------------------------------------------------------------- #
# Phase 14: plant scale.
# --------------------------------------------------------------------------- #

# The plant-scale example (artist_tpu_torch/examples/plant_scale_aim_points.py, the
# counterpart of examples/plant_scale_aim_points.py) at its defaults: 4,000
# heliostats in chunks of 500, 2 rays a point, 50 x 50 points a facet x 4 facets,
# max_epoch 10 (the loop runs epochs 0-10), 256 x 256, K = 16: 80 M rays an epoch,
# 8 chunks of 10 M. PLANT_SHORT_EPOCHS is the max_epoch of the short chunked call
# (the slope's other end) and of the unchunked call it is compared with.
PLANT_SHORT_EPOCHS = 1
# Chunked against unchunked: the JAX package's own tolerances for the same
# comparison (tests/optim/test_aim_point_optimizer.py:140-149). One history entry
# needs more on the card: the flux integral, 100 (sum - ref + 1e-8) / ref with ref
# the sum of the epoch-0 references' forward. At epoch 0 it is the gap between two
# forwards of the same motors: 0 where the forward is deterministic (the CPU), but
# row 1 orders a pixel's deposits differently in each launch, and two forwards of 80 M
# rays part by ~1e-7 of the sum (9.1e-6 after the 100, unchunked, on the H100). So
# that entry is allowed, besides the JAX tolerance, each run's own epoch-0 gap: the
# spread the card shows between two forwards, measured in the same runs.
PLANT_HISTORY_TOLERANCE = dict(rtol=2e-4, atol=1e-6)
PLANT_FACTOR_TOLERANCE = 1e-4
# bench.py's xl_field entry (:109-122, :907-950): 4,000 heliostats x 2 rays a
# point, ray chunks of max(1, rays // 2) = 1 (_field_entry, :845), heliostat
# chunks of 500; blocking off, and on at K = 16 and the sweep's 8 and 32.
XL = dict(heliostats=4000, rays=2, ray_chunk=1, heliostat_chunk=500)
XL_CANDIDATES = (16, 8, 32)
# The chunked step against the unchunked one: tests/parallel/test_microbatch.py's
# tolerances for the JAX package's (1e-4 of the loss, 1e-5 of the largest
# gradient entry).
XL_LOSS_RTOL = 1e-4
XL_GRADIENT_ATOL = 1e-5
# The LBVH traversal's operations a visited node (csrc/lbvh.cu's head note).
LBVH_OPS_PER_VISIT = 25
PLANT_CHUNK_HELIOSTATS = 500  # the heliostats of one chunk: phases 14c and 14d take the first


def plant_aim_point_launches(epochs: int, chunks: int, candidates: int | None = AIM_CANDIDATES) -> dict[str, int]:
    """Launches of an ``optimize()`` call of ``epochs`` epochs whose field is cut into
    ``chunks`` checkpointed heliostat chunks (1: unchunked). Counted on the CPU
    (``tests/test_torch_plant_scale.py``): the epoch-0 references run each chunk's
    forward once; an epoch runs it, and the backward's recompute runs it again (the
    chunk's saved tensors include the splat's and sigma's inputs and the mask's
    exponential, so no kernel of the chunk is skipped); each chunk's backward once.
    Unchunked, nothing is recomputed."""
    recompute = 2 if chunks > 1 else 1
    per_epoch, per_call = AIM_LAUNCHES_PER_EPOCH[candidates], AIM_LAUNCHES_PER_CALL[candidates]
    # The forward kernels are those the epoch-0 references launch (per_call).
    return {
        name: chunks * (per_epoch[name] * epochs * (recompute if per_call[name] else 1) + per_call[name])
        for name in KERNELS
    }


def xl_step_launches(chunks: int, ray_chunks: int, candidates: int | None, blocking: bool) -> dict[str, int]:
    """Launches of one step of bench.py's flagship step with ``chunks`` heliostat chunks
    (1: unchunked) and ``ray_chunks`` checkpointed ray chunks. Counted on the CPU
    (``tests/test_torch_plant_scale.py``): unchunked, each ray chunk runs the splat
    forward twice (forward and recompute) and the sigma forward once (the selective
    checkpoint saves sigma). Chunked, the heliostat chunk's recompute runs each ray
    chunk's forward once more: the splat forward three times, the sigma forward
    twice (the inner checkpoint saves it in that recompute)."""
    rays = chunks * ray_chunks
    splat_forward = (3 if chunks > 1 else 2) * rays
    sigma_forward = (2 if chunks > 1 else 1) * rays
    if not blocking:
        return launches(splat_forward=splat_forward, splat_backward=rays)
    if candidates is None:
        return launches(splat_forward=splat_forward, splat_backward=rays, blocking_cull=sigma_forward,
                        blocking_sigma_flat_forward=sigma_forward, blocking_sigma_flat_backward=rays)
    return launches(splat_forward=splat_forward, splat_backward=rays, blocking_sigma_forward=sigma_forward,
                    blocking_sigma_backward=rays)


def run_plant_example(device: torch.device, chunk: int | None, epochs: int, **size) -> dict:
    """One call of the plant-scale example's entry function, launch counts set to 0 just
    before it and its peak memory read just after: the example's result with
    ``launches`` and ``max_memory_allocated``."""
    synchronize(device)
    reset_peak_memory(device)
    reset_launch_counts()
    result = plant_scale_aim_points.run(chunk=chunk, epochs=epochs, device=device, **size)
    synchronize(device)
    result["launches"] = launch_counts()
    result["max_memory_allocated"] = max_memory(device)
    return result


def check_plant_run(phase: str, result: dict, heliostats: int, epochs: int, chunks: int) -> None:
    """A plant-scale call's gates: its launch counts, ``epochs + 1`` finite losses,
    finite factors, and motors that moved and stayed within their limits and the tanh bound."""
    expected = plant_aim_point_launches(epochs + 1, chunks)
    if result["optimizer"].device.type == "cuda" and result["launches"] != expected:
        raise AssertionError(f"{phase} launched {result['launches']}, expected {expected}")
    losses = result["history"]["total_loss"]
    if len(losses) != epochs + 1 or not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: losses {losses}")
    for name in ("intercepts", "on_targets", "blockings"):
        if result[name].shape != (heliostats,) or not torch.isfinite(result[name]).all():
            raise AssertionError(f"{phase}: {name} not finite or of the wrong shape")
    optimizer = result["optimizer"]
    group = optimizer.scenario.heliostat_groups[0]
    motors, initial = group.motor_positions, optimizer.initial_motor_positions_all_groups[0]
    scale = optimizer.scales_all_groups[0]
    minimum = group.actuator_non_optimizable[:, actuator_min_motor_position]
    maximum = group.actuator_non_optimizable[:, actuator_max_motor_position]
    moved = float((motors != initial).double().mean())
    within = bool(((motors - initial).abs() <= scale * (1 + 1e-6)).all() and (motors >= minimum).all()
                  and (motors <= maximum).all())
    if not (torch.isfinite(motors).all() and moved > 0.5 and within):
        raise AssertionError(f"{phase}: motors moved {moved}, within their limits and the tanh bound {within}")


def drive_plant_aim_point(device: torch.device, size: dict | None = None) -> dict:
    """Phase 14a: the plant-scale example through its entry function at its defaults.
    First the field unchunked for PLANT_SHORT_EPOCHS (max_epoch; it also warms the
    card up), then a chunked call of as many epochs and the example's own (max_epoch
    EPOCHS), the seconds an epoch as the slope between the two chunked calls. The
    unchunked call's histories, intercepts, on-target and blocking factors are held
    to the short chunked call's (PLANT_HISTORY_TOLERANCE, PLANT_FACTOR_TOLERANCE),
    and its peak memory must exceed the chunked one's.
    ``size`` overrides the example's field (heliostats, rays, points) and chunk."""
    size = {**dict(heliostats=plant_scale_aim_points.HELIOSTATS, rays=plant_scale_aim_points.RAYS,
                   points=plant_scale_aim_points.POINTS, chunk=plant_scale_aim_points.CHUNK), **(size or {})}
    chunk = size.pop("chunk")
    heliostats = size["heliostats"]
    chunks = heliostats // chunk
    long_epochs = plant_scale_aim_points.EPOCHS
    unchunked = run_plant_example(device, None, PLANT_SHORT_EPOCHS, **size)
    check_plant_run("phase 14a plant aim point, unchunked", unchunked, heliostats, PLANT_SHORT_EPOCHS, 1)
    short = run_plant_example(device, chunk, PLANT_SHORT_EPOCHS, **size)
    check_plant_run("phase 14a plant aim point, short call", short, heliostats, PLANT_SHORT_EPOCHS, chunks)
    long = run_plant_example(device, chunk, long_epochs, **size)
    check_plant_run("phase 14a plant aim point", long, heliostats, long_epochs, chunks)
    long_line = plant_scale_aim_points.summary(heliostats, chunk, long)

    gaps = {}
    for key, values in short["history"].items():
        mine, other = np.asarray(unchunked["history"][key]), np.asarray(values)
        gaps[key] = float(np.abs(mine - other).max()) if mine.size else 0.0
        spread = abs(mine[0]) + abs(other[0]) if key == "flux_integral" else 0.0
        np.testing.assert_allclose(mine, other, rtol=PLANT_HISTORY_TOLERANCE["rtol"],
                                   atol=PLANT_HISTORY_TOLERANCE["atol"] + spread,
                                   err_msg=f"phase 14a: history {key}, unchunked against chunked")
    for name in ("intercepts", "on_targets", "blockings"):
        gaps[name] = _max_abs_err(unchunked[name], short[name])
        if not gaps[name] <= PLANT_FACTOR_TOLERANCE:
            raise AssertionError(f"phase 14a: {name} unchunked against chunked {gaps[name]} > {PLANT_FACTOR_TOLERANCE}")
    if device.type == "cuda" and not short["max_memory_allocated"] < unchunked["max_memory_allocated"]:
        raise AssertionError(
            f"phase 14a: chunked peak {short['max_memory_allocated']} B, unchunked {unchunked['max_memory_allocated']} B"
        )
    epochs_long, epochs_short = long_epochs + 1, PLANT_SHORT_EPOCHS + 1
    epoch_seconds = (long["seconds"] - short["seconds"]) / (epochs_long - epochs_short)
    rays = heliostats * size["rays"] * 4 * size["points"] ** 2
    result = dict(
        launches=long["launches"],
        epochs=(epochs_short, epochs_long),
        call_seconds=(short["seconds"], long["seconds"]),
        epoch_seconds=epoch_seconds,
        rays_per_epoch=rays,
        rays_per_second=rays / epoch_seconds,
        max_memory_allocated=long["max_memory_allocated"],
        short_max_memory_allocated=short["max_memory_allocated"],
        unchunked_max_memory_allocated=unchunked["max_memory_allocated"],
        unchunked_seconds=unchunked["seconds"],
        losses=long["history"]["total_loss"],
        unchunked_gaps=gaps,
        flux_integral_epoch0=(unchunked["history"]["flux_integral"][0], short["history"]["flux_integral"][0]),
        blocking_factor_mean=float(long["blockings"].mean()),
        intercept_mean=float(long["intercepts"].mean()),
    )
    _log(
        f"phase 14a plant aim point (the example's entry function, {heliostats} heliostats in chunks of {chunk}, "
        f"{rays} rays an epoch, K = {plant_scale_aim_points.CANDIDATES}): {long_line}; calls of {epochs_short} and "
        f"{epochs_long} epochs {short['seconds']:.3f} s and {long['seconds']:.3f} s, {epoch_seconds:.6f} s an epoch "
        f"(slope), {result['rays_per_second']:.6g} rays/s, max_memory_allocated {long['max_memory_allocated']} B "
        f"(short call {short['max_memory_allocated']} B), launches {long['launches']}; unchunked, {epochs_short} "
        f"epochs in {unchunked['seconds']:.3f} s, max_memory_allocated {unchunked['max_memory_allocated']} B, "
        f"largest gaps to the chunked call {json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})}, epoch-0 "
        f"flux integral (two forwards' spread) {result['flux_integral_epoch0'][0]:.3g} unchunked, "
        f"{result['flux_integral_epoch0'][1]:.3g} chunked"
    )
    return result


def xl_inputs(device: torch.device, blocking: bool, candidates: int | None, heliostat_chunk: int | None,
              size: dict = XL) -> StepInputs:
    """bench.py's flagship step at the xl_field entry's size (``size``: heliostats, rays
    a point, ray chunk, and optionally surface points and bitmap), its heliostat axis
    in chunks of ``heliostat_chunk``."""
    return field_inputs(
        device, size["heliostats"], size.get("surface_points", SURFACE_POINTS), size["rays"],
        size.get("bitmap", BITMAP), size["ray_chunk"], blocking, candidates, heliostat_chunk,
    )


def xl_loss_and_gradient(inputs: StepInputs) -> tuple[float, torch.Tensor]:
    """The step's loss and control-point gradient, without an update."""
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    loss = surface_loss(control_points, inputs)
    loss.backward()
    return loss.item(), control_points.grad


def drive_xl_step(device: torch.device, size: dict = XL) -> dict[str, dict]:
    """Phase 14b: bench.py's xl_field step with heliostat chunks, blocking off and on at
    each K of XL_CANDIDATES (one warm-up and STEPS timed Adam steps each, launch counts
    asserted), then the chunked step's loss and gradient (K = 16) against the unchunked
    step's, with both peaks."""
    heliostats, chunk = size["heliostats"], size["heliostat_chunk"]
    chunks, ray_chunks = heliostats // chunk, size["rays"] // size["ray_chunk"]
    results = {}
    for blocking, candidates in ((False, AIM_CANDIDATES), *((True, k) for k in XL_CANDIDATES)):
        key = f"k{candidates}" if blocking else "plain"
        empty_cache(device)
        results[key] = drive_surface_step(
            xl_inputs(device, blocking, candidates, chunk, size),
            xl_step_launches(chunks, ray_chunks, candidates, blocking),
            f"phase 14b XL step ({heliostats} heliostats in chunks of {chunk}, "
            + (f"blocking K = {candidates})" if blocking else "no blocking)"),
        )
    comparison = {}
    for label, heliostat_chunk in (("chunked", chunk), ("unchunked", None)):
        empty_cache(device)
        inputs = xl_inputs(device, True, AIM_CANDIDATES, heliostat_chunk, size)
        synchronize(device)
        reset_peak_memory(device)
        loss, grad = xl_loss_and_gradient(inputs)
        comparison[label] = (loss, grad, max_memory(device))
        del inputs
    (loss, grad, peak), (loss_plain, grad_plain, peak_plain) = comparison["chunked"], comparison["unchunked"]
    scale = float(grad_plain.abs().max())
    loss_gap = abs(loss - loss_plain) / abs(loss_plain)
    gradient_gap = _max_abs_err(grad, grad_plain) / scale
    _log(
        f"phase 14b XL step, chunked against unchunked (K = {AIM_CANDIDATES}): loss {loss:.9g} and {loss_plain:.9g} "
        f"(relative gap {loss_gap:.3g}, limit {XL_LOSS_RTOL}), largest gradient gap {gradient_gap:.3g} of the "
        f"largest entry {scale:.4g} (limit {XL_GRADIENT_ATOL}), max_memory_allocated {peak} B chunked, "
        f"{peak_plain} B unchunked"
    )
    if not (np.isfinite(loss) and scale > 0 and torch.isfinite(grad).all()):
        raise AssertionError("phase 14b: the chunked step's loss or gradient is not finite, or the gradient is 0")
    if not (loss_gap <= XL_LOSS_RTOL and gradient_gap <= XL_GRADIENT_ATOL):
        raise AssertionError(f"phase 14b: chunked against unchunked, loss gap {loss_gap}, gradient gap {gradient_gap}")
    results["comparison"] = dict(loss_gap=loss_gap, gradient_gap=gradient_gap, chunked_max_memory_allocated=peak,
                                 unchunked_max_memory_allocated=peak_plain)
    return results


def plant_chunk_inputs(device: torch.device, row_spacing: float | None, heliostats: int = XL["heliostats"],
                       chunk: int = PLANT_CHUNK_HELIOSTATS, surface_points=SURFACE_POINTS, rays: int = XL["rays"]) -> dict:
    """The plant-scale aim point's first chunk at its first epoch, the field's rows
    ``row_spacing`` apart if given: every heliostat aligned by its initial motor
    positions, the whole field's primitives, and the first ``chunk`` heliostats'
    rays (the optimizer's sun distortions, seed SEED). Returns the blocking mask's
    inputs (``origins [c, P, 4]``, ``directions [c, R, P, 4]``, ``t_target [c, R,
    P]``, ``own [c]``, ``primitives``) and the splat's (``splat``: e, u and the
    intensities before blocking, each ``[c, R P]``)."""
    scenario = aim_point_scenario(device, heliostats, surface_points, rays, row_spacing)
    group = scenario.heliostat_groups[0]
    tower = scenario.solar_tower
    every = torch.arange(heliostats, device=device)
    targets = torch.zeros(heliostats, dtype=torch.long, device=device)
    incident = torch.tensor([0.0, 1.0, 0.0, 0.0], device=device).expand(heliostats, 4)
    with torch.no_grad():
        active = hg.gather_active(group, every)
        motors = hg.align_surfaces_with_incident_ray_directions(
            active, get_centers_of_target_areas(tower, targets), incident
        )[3]
        points, normals = hg.align_surfaces_with_motor_positions(active, motors)[:2]
        primitives = create_blocking_primitives_rectangles_by_index(points)
        distortions_u, distortions_e = scenario.light_sources[0].get_distortions(
            torch.Generator(device=device).manual_seed(SEED), points.shape[1], heliostats
        )
        part = slice(0, chunk)
        traced = ray_splat_inputs(
            tower, geometry.reflect(incident[part, None, :], normals[part]), points[part], targets[part],
            distortions_u[part], distortions_e[part], 1.0,
            RenderConfig(bitmap_resolution=BITMAP, blocking_active=False),
        )
    return dict(
        origins=points[part].contiguous(),
        directions=traced.ray_directions,
        t_target=traced.distances,
        own=every[part],
        primitives=primitives,
        splat=tuple(x.reshape(chunk, -1).contiguous() for x in (traced.bitmap_e, traced.bitmap_u,
                                                                   traced.final_intensities)),
    )


def lbvh_tree_checks(tree) -> dict:
    """The tree's shape: the leaves a walk from the root reaches, the most visits of a
    node, and whether every child's box lies inside its parent's. ``tree``'s arrays are
    tensors or anything numpy reads."""
    def numpy(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    left, right, leaf = numpy(tree.left), numpy(tree.right), numpy(tree.is_leaf)
    visits = np.zeros(left.shape[0], np.int64)
    stack = [0]
    while stack:
        node = stack.pop()
        visits[node] += 1
        if not leaf[node]:
            stack += [left[node], right[node]]
    internal = np.nonzero(~leaf)[0]
    children = np.concatenate([left[internal], right[internal]])
    parents = np.concatenate([internal, internal])
    lo, hi = numpy(tree.aabb_min), numpy(tree.aabb_max)
    nested = bool((lo[children] >= lo[parents]).all() and (hi[children] <= hi[parents]).all())
    return dict(leaves_reached=int((visits[leaf] > 0).sum()), leaves=int(leaf.sum()),
                most_visits=int(visits.max()), nested=nested)


def check_lbvh(device: torch.device, **size) -> tuple[dict, dict]:
    """Phase 14c: the LBVH on one plant chunk's first-epoch rays against the whole
    field's primitives, on the synthetic field (12 m rows) and with the rows 3 m apart:
    the tree reaches every leaf once and nests its boxes; the kernel's keep flags equal
    its plain version's and row 5's cull kernel's bit for bit; kernel and cull timed
    side by side; and ``soft_ray_blocking_mask(cull_method="lbvh")`` (launch counts set
    to 0 just before it) equal to the dense cull's flat route bit for bit. Returns the
    kernel's timings and the path's result."""
    parameters = (1000.0, 0.05, 1e-12)
    cases, path = {}, {}
    for label, spacing in (("synthetic field", None), ("dense rows", DENSE_ROW_SPACING)):
        chunk_inputs = plant_chunk_inputs(device, spacing, **size)
        origins, directions, t_target, own = (chunk_inputs[k] for k in ("origins", "directions", "t_target", "own"))
        corners, spans, normals = chunk_inputs["primitives"]
        del chunk_inputs
        num, rays, points = directions.shape[:3]
        flat_directions = directions.reshape(num, rays * points, 4).contiguous()
        flat_t = t_target.reshape(num, rays * points).contiguous()
        own = own.to(torch.int64).contiguous()
        tree = lbvh.build_linear_bounding_volume_hierarchies(corners)
        shape = lbvh_tree_checks(tree)
        count = corners.shape[0]
        if not (shape["leaves_reached"] == count and shape["most_visits"] == 1 and shape["nested"]):
            raise AssertionError(f"phase 14c {label}: the tree is malformed ({shape})")
        nodes = lbvh.lbvh_nodes(tree)
        cull_inputs = (origins, flat_directions, flat_t, own)
        aabb = torch.cat([corners[:, :, :3].amin(dim=1), corners[:, :, :3].amax(dim=1)], dim=1).contiguous()
        keep = lbvh_kernels.traverse_cuda(*cull_inputs, nodes)
        plain, visits = lbvh_kernels.traverse_plain(*cull_inputs, nodes, count_visits=True)
        cull = blocking_kernels.cull_cuda(*cull_inputs, aabb)
        synchronize(device)
        if not (torch.equal(keep, plain) and torch.equal(keep, cull)):
            raise AssertionError(
                f"phase 14c {label}: LBVH keeps {int(keep.sum())}, its plain version {int(plain.sum())}, "
                f"the cull {int(cull.sum())} ({int((keep != cull).sum())} differ)"
            )
        mask_arguments = (origins, directions, corners, spans, normals)
        mask_options = dict(intersection_distances_target=t_target, ray_primitive_indices=own)
        with torch.no_grad():
            dense = soft_ray_blocking_mask(*mask_arguments, **mask_options, max_candidates=None)
            synchronize(device)
            reset_launch_counts()
            mask = soft_ray_blocking_mask(*mask_arguments, **mask_options, max_candidates=AIM_CANDIDATES,
                                          cull_method="lbvh")
            synchronize(device)
        counted = launch_counts()
        if not torch.equal(mask, dense):
            raise AssertionError(f"phase 14c {label}: the LBVH mask differs from the dense cull's at "
                                 f"{int((mask != dense).sum())} rays")
        if device.type == "cuda" and counted != launches(lbvh_traverse=1, blocking_sigma_flat_forward=1):
            raise AssertionError(f"phase 14c {label}: the LBVH mask launched {counted}")
        path.setdefault("launches", counted)
        bytes_moved = 16 * num * points + 20 * num * rays * points + 8 * num + 32 * nodes.shape[0] + 4 * count
        cases[label] = dict(
            ms=event_ms(lambda: lbvh_kernels.traverse_cuda(*cull_inputs, nodes)),
            with_build_ms=event_ms(lambda: lbvh.lbvh_keep(origins, directions, corners, own, t_target)),
            cull_ms=event_ms(lambda: blocking_kernels.cull_cuda(*cull_inputs, aabb)),
            plain_ms=event_ms(lambda: lbvh_kernels.traverse_plain(*cull_inputs, nodes), 1, 0),
            bound=bound_ms(bytes_moved, LBVH_OPS_PER_VISIT * visits),
            visits=visits,
            kept=int(keep.sum()),
            blocked_share=float((mask >= 1e-3).double().mean()),
            shape=[num, rays * points, count],
            tree=shape,
        )
        del origins, directions, t_target, flat_directions, flat_t, mask, dense, corners, spans, normals
        empty_cache(device)
    _log(
        "phase 14c LBVH: "
        + "; ".join(
            f"{label} ([{c['shape'][0]}, {c['shape'][1]}] rays against {c['shape'][2]} primitives): tree reaches "
            f"{c['tree']['leaves_reached']} of {c['tree']['leaves']} leaves, each node at most "
            f"{c['tree']['most_visits']} time(s), boxes nested {c['tree']['nested']}; keeps {c['kept']} (kernel, plain "
            f"and cull bit-equal), mask bit-equal to the dense cull's (blocked share {c['blocked_share']:.4g}); "
            f"{c['visits']} node visits ({c['visits'] / (c['shape'][0] * c['shape'][1]):.2f} a ray); traversal "
            f"kernel {c['ms']:.4f} ms ({c['with_build_ms']:.4f} ms with the build), cull kernel {c['cull_ms']:.4f} ms, "
            f"plain {c['plain_ms']:.2f} ms, bound {c['bound'][0]:.4f} ms ({c['bound'][1]})"
            for label, c in cases.items()
        )
        + f"; launches of the LBVH mask {path['launches']}"
    )
    first = cases["synthetic field"]
    timings = {
        "lbvh_traverse": dict(
            ms=first["ms"], plain_ms=first["plain_ms"], bound=first["bound"], library_ms=None, max_abs_err=0.0,
            replaces="artist_tpu/raytracing/lbvh.py:337 (lbvh_filter_blocking_planes's vmap-ed lax.while_loop "
                     "traversal; no Pallas kernel)",
            with_build_ms=first["with_build_ms"], cull_ms=first["cull_ms"], visits=first["visits"],
            dense_rows={k: cases["dense rows"][k] for k in ("ms", "with_build_ms", "cull_ms", "plain_ms", "visits",
                                                            "kept")}
            | {"bound_ms": cases["dense rows"]["bound"][0], "bound_by": cases["dense rows"]["bound"][1]},
        )
    }
    return timings, path


def check_plant_kernels(device: torch.device, **size) -> dict[str, dict]:
    """Phase 14d: rows 1-2 and 9-10 at the plant chunk's shape (the first chunk's
    first-epoch rays, ``[500, 20000]`` onto ``[500, 256, 256]``, and its K = 16 sigma
    pair against the whole field's primitives), each against its plain version (the
    sigma pair against the float64 arbiter), timed beside ``index_add_`` (row 1) and
    its bound; the sigma pair also timed at K = 32. Returns the timings, by kernel,
    under "plant_chunk" (and "plant_chunk_k32")."""
    width, height = BITMAP
    chunk_inputs = plant_chunk_inputs(device, None, **size)
    corners, spans, normals = chunk_inputs["primitives"]
    directions = chunk_inputs["directions"]
    # The XL step's sweep also runs the pair at K = 32 (rows 11-12): timed, not checked (phase 3b holds it).
    capture, wide = CaptureBlockingInputs(), CaptureBlockingInputs()
    for candidates, recorder in ((AIM_CANDIDATES, capture), (2 * AIM_CANDIDATES, wide)):
        with torch.no_grad(), recorder:
            soft_ray_blocking_mask(
                chunk_inputs["origins"], directions, corners, spans, normals,
                intersection_distances_target=chunk_inputs["t_target"], ray_primitive_indices=chunk_inputs["own"],
                max_candidates=candidates,
            )
    (arguments,) = capture.calls["blocking_sigma"]
    sigma_inputs_, sigma_parameters = tuple(arguments[:5]), tuple(arguments[5:])
    gbar = torch.randn(sigma_inputs_[2].shape, device=device,
                       generator=torch.Generator(device=device).manual_seed(SEED + 3))
    sigma = check_sigma_pair("plant chunk", sigma_inputs_, sigma_parameters, gbar)
    counts = sigma_pair_counts(sigma_inputs_, sigma_parameters, gbar)
    sigma_timings = time_sigma_pair(sigma_inputs_, sigma_parameters, gbar, counts)
    (arguments,) = wide.calls["blocking_sigma"]
    wide_inputs = tuple(arguments[:5])
    wide_timings = time_sigma_pair(wide_inputs, sigma_parameters, gbar,
                                   sigma_pair_counts(wide_inputs, sigma_parameters, gbar))
    sigma_shape = [directions.shape[0], directions.shape[1] * directions.shape[2], AIM_CANDIDATES]
    rays = chunk_inputs["splat"]
    del chunk_inputs, capture, wide, arguments, sigma_inputs_, wide_inputs, gbar, directions
    empty_cache(device)

    shape = list(rays[0].shape)
    g = torch.randn((shape[0], height, width), device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED + 14))
    forward_err, forward_share = check_forward(
        "splat_forward", splat_forward_cuda(*rays, height, width), splat_forward_plain(*rays, height, width),
        rays, height, width,
    )
    backward_errs, backward_share = check_backward(
        "splat_backward", splat_backward_cuda(*rays, g, height, width), splat_backward_plain(*rays, g, height, width),
        rays[2], g,
    )
    splat_timings, work = time_splat_pair(rays, g, height, width, iterations=5)
    splat_timings["splat_forward"]["max_abs_err"] = forward_err
    splat_timings["splat_backward"]["max_abs_err"] = max(backward_errs)
    sigma_timings["blocking_sigma_forward"]["max_abs_err"] = sigma["forward_err"]
    sigma_timings["blocking_sigma_backward"]["max_abs_err"] = sigma["backward_err"]
    timed = {**splat_timings, **sigma_timings}
    for name, t in wide_timings.items():
        t["max_abs_err"] = None
        timed[f"{name}, K = {2 * AIM_CANDIDATES}"] = t
    _log(
        f"phase 14d kernels at the plant chunk: splat {shape} rays ({work['valid']} valid, {work['touched']} pixels "
        f"touched) -> [{shape[0]}, {height}, {width}], worst error {max(forward_share, backward_share):.3g} of its "
        f"tolerance; sigma [{sigma_shape[0]}, {sigma_shape[1]}] rays x K = {AIM_CANDIDATES}: kept candidates "
        f"{sigma['kept_candidates']}, {describe_counts(counts)}, worst share of the arbiter's limit "
        + json.dumps({k: round(v, 4) for k, v in sigma["worst_share"].items()})
        + "; "
        + "; ".join(
            f"{name} max_abs_err {'not checked' if t['max_abs_err'] is None else format(t['max_abs_err'], '.3g')}, "
            f"kernel {t['ms']:.4f} ms"
            + (f" ({t['graph_ms']:.4f} ms replayed from a CUDA graph)" if "graph_ms" in t else "")
            + f", plain {t['plain_ms']:.4f} ms, library "
            f"{t.get('library_ms') if t.get('library_ms') is None else round(t['library_ms'], 4)} ms, "
            + describe_bound(t)
            for name, t in timed.items()
        )
    )
    results: dict[str, dict] = {}
    for label, t in timed.items():
        name, _, wide_label = label.partition(", ")
        key = "plant_chunk_k32" if wide_label else "plant_chunk"
        results.setdefault(name, {})[key] = dict(
            shape=shape if name.startswith("splat") else sigma_shape[:2] + [2 * AIM_CANDIDATES if wide_label else AIM_CANDIDATES],
            ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t.get("library_ms"), bound_ms=t["bound"][0],
            bound_by=t["bound"][1], max_abs_err=t["max_abs_err"], **({"graph_ms": t["graph_ms"]} if "graph_ms" in t else {}),
        )
    return results


# The path whose run gives a kernel's "launches": the flat aim point (phase 8)
# for every kernel it runs; the compacted aim point (phase 5) for the compacted
# sigma kernels; the block-window step (phase 10) for the dynamic-window pair;
# the formulation tool (phase 11) for its kernels; the LBVH mask at the plant
# chunk (phase 14c) for the LBVH traversal. "launches_by_path" gives every path's,
# the plant-scale example's (phase 14a) and the XL steps' (14b) among them.
# --------------------------------------------------------------------------- #
# Multi-process runs (phase 16).
# --------------------------------------------------------------------------- #

# Each optimizer at the widths of its production phase (surface: phase 12; kinematics:
# phase 13, both methods; aim point: phase 14's plant field), for DISTRIBUTED_EPOCHS
# (max_epoch) on a fresh field. A world of one runs each twice on the field as one
# group and twice split into two groups (split_into_groups), without a setup and
# with an NCCL setup of one rank; a world of two gloo ranks, both on the card, runs
# the two-group field group-parallel and the one-group field nested (mesh (2, 1):
# the samples, or the aim point's heliostats, split over the ranks).
RAYTRACING = constants.kinematics_reconstruction_raytracing
ALIGNMENT = constants.kinematics_reconstruction_alignment
DISTRIBUTED_OPTIMIZERS = ("surface", RAYTRACING, ALIGNMENT, "aim_point")
DISTRIBUTED_EPOCHS = {"surface": 3, RAYTRACING: 2, ALIGNMENT: 20, "aim_point": 2}
# Samples a heliostat of the kinematics runs (phase 13's 20; cut here, never the rays,
# the bitmap or the surface points, if two ranks do not fit on the card).
DISTRIBUTED_KINEMATICS_SAMPLES = KINEMATICS["samples"]
DISTRIBUTED_PLANT_CHUNK = plant_scale_aim_points.CHUNK
DISTRIBUTED_TIMEOUT = 300.0  # seconds a collective waits for the other rank
# World two against world one: the JAX package's tolerances
# (tests/parallel/test_distributed.py:80-190), losses relative, parameters absolute,
# except two that ask for bit equality, which the card does not give: row 1 orders a
# pixel's deposits differently in each launch, so two runs of one process part by
# rounding, and Adam turns a rounding-level change of a small gradient entry into a
# visible change of its step. Motor positions (~6.5e4 steps, float32 spacing 0.0039
# there; JAX's 1e-3 is below it) are held to MOTOR_STEPS, about three times the largest
# gap read between two runs that should agree (0.027 steps between two world-one runs,
# 0.031 between world two and world one, on an H100 80GB HBM3 at 700 W); factors (ray
# counts over rays x points) to FACTOR_RAYS rays of a heliostat, where the same runs
# parted by one ray (5e-5). The first gradients are held to GRADIENT_SHARE of their largest entry: a
# backward that sums a replicated cotangent doubles them, and Adam's scale-free step
# hides that from the parameters.
GROUP_PARALLEL_TOLERANCE = dict(loss=1e-5, aim_point_loss=1e-4, parameters=1e-6)
NESTED_TOLERANCE = dict(loss=1e-4, aim_point_loss=1e-4, parameters=1e-5)
MOTOR_STEPS = 0.1
FACTOR_RAYS = 2
GRADIENT_SHARE = 1e-3


def distributed_optimizer(device: torch.device, name: str, groups: int, setup, data: CalibrationData | None):
    """A fresh field of ``groups`` groups and ``name``'s optimizer on it, at its production widths."""
    if name == "surface":
        scenario = make_synthetic_scenario(
            number_of_heliostats=RECON_HELIOSTATS, number_of_control_points_per_facet=RECON_CONTROL_POINTS,
            number_of_surface_points_per_facet=RECON_SURFACE_POINTS, number_of_rays=RECON_RAYS, device=device,
        )
        return SurfaceReconstructor(
            scenario=split_into_groups(scenario, groups) if groups > 1 else scenario,
            data={constants.data_parser: SyntheticCalibrationParser(samples_per_heliostat=RECON_SAMPLES),
                  constants.heliostat_data_mapping: []},
            optimization_configuration=reconstruction_configuration(DISTRIBUTED_EPOCHS[name]),
            number_of_surface_points=RECON_SURFACE_POINTS, bitmap_resolution=BITMAP, ray_chunk=RECON_RAY_CHUNK,
            seed=SEED, distributed_setup=setup,
        )
    if name in (RAYTRACING, ALIGNMENT):
        scenario = kinematics_scenario(device, KINEMATICS)
        return KinematicsReconstructor(
            scenario=split_into_groups(scenario, groups) if groups > 1 else scenario,
            data={constants.data_parser: CalibrationSamples(data), constants.heliostat_data_mapping: []},
            optimization_configuration=kinematics_configuration(DISTRIBUTED_EPOCHS[name]),
            reconstruction_method=name, bitmap_resolution=KINEMATICS["bitmap"], seed=SEED, distributed_setup=setup,
        )
    scenario = make_synthetic_scenario(
        number_of_heliostats=plant_scale_aim_points.HELIOSTATS,
        number_of_surface_points_per_facet=(plant_scale_aim_points.POINTS,) * 2,
        number_of_rays=plant_scale_aim_points.RAYS, device=device,
    )
    return AimPointOptimizer(
        scenario=split_into_groups(scenario, groups) if groups > 1 else scenario,
        optimization_configuration=plant_scale_aim_points.configuration(DISTRIBUTED_EPOCHS[name]),
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        target_area_index=0,
        ground_truth=plant_scale_aim_points.ground_truth(),
        dni=DNI,
        bitmap_resolution=plant_scale_aim_points.RESOLUTION,
        blocking_candidates=plant_scale_aim_points.CANDIDATES,
        # The one-group field of the world of one runs unchunked, as the nested
        # ranks do (a mesh of two ranks ignores the chunk, with a warning).
        heliostat_chunk=DISTRIBUTED_PLANT_CHUNK if groups > 1 or setup is not None and setup.is_nested else None,
        distributed_setup=setup,
    )


def distributed_launches(name: str, groups_run: int, epochs: list[int], chunks: int) -> dict[str, int]:
    """The launches of one phase-16 call that ran ``groups_run`` groups, the epochs of
    each in ``epochs`` (each group's run from 0), ``chunks`` heliostat chunks in all
    (aim point)."""
    max_epoch = DISTRIBUTED_EPOCHS[name]
    if name == "surface":
        return {k: v * groups_run for k, v in reconstruction_launches(max_epoch).items()}
    if name == "aim_point":
        return plant_aim_point_launches(max_epoch + 1, chunks)
    starts = [i for i, epoch in enumerate(epochs) if epoch == 0] + [len(epochs)]
    total = launches()
    log_step = kinematics_configuration(max_epoch)[constants.optimization][constants.log_step]
    for start, end in zip(starts[:-1], starts[1:]):
        run = epochs[start:end]
        for kernel, count in kinematics_launches(name, run, max_epoch, log_step, run[-1] < max_epoch).items():
            total[kernel] += count
    return total


def run_distributed(device: torch.device, name: str, groups: int, setup, data: CalibrationData | None) -> dict:
    """One phase-16 call of ``name``'s optimizer on a fresh field of ``groups`` groups
    under ``setup`` (None: no setup): its losses, parameters (and the aim point's
    factors) in numpy, the seconds and collective seconds of each epoch, the launches
    (asserted against :func:`distributed_launches`) and the peak memory."""
    optimizer = distributed_optimizer(device, name, groups, setup, data)
    epochs, ends, collective = [], [], []

    def on_epoch(epoch: int, loss: float) -> None:
        epochs.append(epoch)
        ends.append(time.perf_counter())
        collective.append(collectives.STATISTICS["seconds"])

    synchronize(device)
    empty_cache(device)
    reset_peak_memory(device)
    reset_launch_counts()
    collectives.reset_statistics()
    start = time.perf_counter()
    out: dict = {}
    if name in (RAYTRACING, ALIGNMENT):
        # The gradient's index_add_ sums a heliostat's samples in a fixed order, as in
        # phase 13c: the alignment loss turns the atomics' rounding into a trajectory of
        # its own (two runs of one process parted by 23% of the loss in 21 epochs).
        with deterministic_algorithms():
            out["final_loss"], results = optimizer.reconstruct_kinematics(on_epoch=on_epoch)
        out["histories"] = {r.group_index: np.asarray(r.loss_history) for r in results}
        parameters = [g.rotation_deviations for g in optimizer.scenario.heliostat_groups]
    elif name == "surface":
        out["final_loss"], results = optimizer.reconstruct_surfaces("kl_divergence", on_epoch=on_epoch)
        out["histories"] = {r.group_index: np.asarray(r.loss_history["total_loss"]) for r in results}
        parameters = [g.nurbs_control_points for g in optimizer.scenario.heliostat_groups]
    elif name == "aim_point":
        loss, history, *factors = optimizer.optimize("kl_divergence", on_epoch=on_epoch)
        out["final_loss"] = np.asarray([loss])
        out["histories"] = {key: np.asarray(history[key]) for key in ("total_loss", "flux_loss")}
        out["factors"] = np.stack([f.cpu().numpy() for f in factors])
        parameters = [g.motor_positions for g in optimizer.scenario.heliostat_groups]
    synchronize(device)
    out["seconds"] = time.perf_counter() - start
    out["parameters"] = [p.detach().cpu().numpy() for p in parameters]
    out["epoch_seconds"] = np.diff([start] + ends).tolist()
    out["collective_seconds"] = np.diff([0.0] + collective).tolist()
    out["collective_calls"] = collectives.STATISTICS["calls"]
    out["launches"] = launch_counts()
    out["max_memory_allocated"] = max_memory(device)
    groups_run = sum(runs_group(setup, g) for g in range(groups))
    chunks = 1
    if name == "aim_point" and optimizer.heliostat_chunk:
        chunks = sum(optimizer.scenario.heliostat_groups[g].number_of_heliostats // optimizer.heliostat_chunk
                     for g in range(groups) if runs_group(setup, g))
    out["expected_launches"] = distributed_launches(name, groups_run, epochs, chunks)
    del optimizer
    empty_cache(device)
    out["gradients"] = first_gradients(device, name, groups, setup, data)
    empty_cache(device)
    return out


def first_gradients(device: torch.device, name: str, groups: int, setup, data: CalibrationData | None) -> list:
    """The first epoch's gradient of every group's parameters (every group's on every rank),
    of a fresh optimizer: ``single_step_gradients`` of the reconstructors, the aim point's
    objective differentiated once."""
    optimizer = distributed_optimizer(device, name, groups, setup, data)
    if name == "aim_point":
        params, forward, loss_fn = optimizer.objective("kl_divergence")
        with torch.no_grad():
            flux, intercepts, _, _ = forward(params)
        zero = torch.zeros((), device=device)
        for param in params:
            param.requires_grad_(True)
        loss, _ = loss_fn(params, (torch.sum(flux), intercepts), (zero, zero, zero))
        loss.backward()
        owned = [g for g in range(groups) if runs_group(setup, g)]
        gradients = collectives.merge_group_outputs(
            setup, {g: p.grad.cpu().numpy() for g, p in zip(owned, params)}
        )
    else:
        with deterministic_algorithms():
            gradients = {g: out["gradients"] for g, out in optimizer.single_step_gradients().items()}
    return [gradients[g] for g in sorted(gradients)]


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms, warning only where an operation has none."""
    enabled = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(enabled)


def save_calibration(path: pathlib.Path, data: CalibrationData) -> None:
    np.savez(path, **dataclasses.asdict(data))


def load_calibration(path: pathlib.Path) -> CalibrationData:
    with np.load(path) as arrays:
        return CalibrationData(**{key: arrays[key] for key in arrays.files})


def distributed_rank(rank: int, port: int, directory: str) -> None:
    """One of phase 16's two gloo ranks on the card: every optimizer group-parallel on the
    two-group field, then nested on the one-group field; pickles the results."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="heliostat_chunk is ignored")
    data = load_calibration(pathlib.Path(directory) / "calibration.npz")
    results = {}
    with setup_distributed_environment(
        2, coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=rank, device="cuda",
        backend="gloo", timeout=DISTRIBUTED_TIMEOUT,
    ) as group_parallel:
        if not (group_parallel.is_distributed and not group_parallel.is_nested):
            raise AssertionError(f"rank {rank}: not a group-parallel setup: {group_parallel}")
        results["group_parallel"] = {
            name: run_distributed(device, name, 2, group_parallel, data) for name in DISTRIBUTED_OPTIMIZERS
        }
        with setup_distributed_environment(1, device="cuda", backend="gloo") as nested:
            if not nested.is_nested:
                raise AssertionError(f"rank {rank}: not a nested setup: {nested}")
            results["nested"] = {name: run_distributed(device, name, 1, nested, data) for name in DISTRIBUTED_OPTIMIZERS}
    with open(pathlib.Path(directory) / f"rank{rank}.pkl", "wb") as handle:
        pickle.dump(results, handle)


def world_of_two(data: CalibrationData) -> list[dict]:
    """Phase 16's two ranks, spawned and joined (a rank that fails fails the phase, and
    the other is stopped): each rank's results."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        save_calibration(pathlib.Path(directory) / "calibration.npz", data)
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        mp.start_processes(distributed_rank, args=(port, directory), nprocs=2, join=True, start_method="spawn")
        ranks = []
        for rank in range(2):
            with open(pathlib.Path(directory) / f"rank{rank}.pkl", "rb") as handle:
                ranks.append(pickle.load(handle))
    return ranks


def distributed_gaps(ours: dict, reference: dict) -> dict[str, float]:
    """The largest gaps of a run to its reference: losses relative, parameters and factors absolute."""
    losses = [ours["final_loss"], *ours["histories"].values()]
    references = [reference["final_loss"], *reference["histories"].values()]
    gaps = {
        "loss": max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) for a, b in zip(losses, references)),
        "parameters": max(float(np.max(np.abs(a - b))) for a, b in zip(ours["parameters"], reference["parameters"])),
        "gradients": max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                         for a, b in zip(ours["gradients"], reference["gradients"])),
    }
    if "factors" in ours:
        gaps["factors"] = float(np.max(np.abs(ours["factors"] - reference["factors"])))
    return gaps


def distributed_limits(name: str, tolerance: dict) -> dict[str, float]:
    """The tolerance of each gap of a run of ``name`` to the run it is held against."""
    limits = {
        "loss": tolerance["aim_point_loss" if name == "aim_point" else "loss"],
        "parameters": tolerance["parameters"],
        "gradients": GRADIENT_SHARE,
    }
    if name == "aim_point":
        limits["parameters"] = MOTOR_STEPS
        rays = plant_scale_aim_points.RAYS * 4 * plant_scale_aim_points.POINTS ** 2
        limits["factors"] = FACTOR_RAYS / rays
    return limits


def distributed_gap_failures(label: str, name: str, gaps: dict, limits: dict) -> list[str]:
    """Each gap above its limit, described."""
    return [f"phase 16 {label} {name}: {key} {gap:.6g} > {limits[key]:.6g}"
            for key, gap in gaps.items() if not gap <= limits[key]]


def describe_run(run: dict) -> str:
    seconds = run["epoch_seconds"]
    steady = seconds[1:] or seconds
    return (
        f"{len(seconds)} epochs in {run['seconds']:.3f} s (median epoch after the first "
        f"{float(np.median(steady)):.6f} s), collectives {sum(run['collective_seconds']):.6f} s "
        f"({run['collective_calls']} calls; median an epoch after the first "
        f"{float(np.median(run['collective_seconds'][1:] or run['collective_seconds'])):.6f} s), "
        f"max_memory_allocated {run['max_memory_allocated']} B"
    )


def drive_distributed(device: torch.device, data: CalibrationData) -> dict:
    """Phase 16: the three optimizers in a world of one on NCCL, then in a world of two
    gloo ranks on the card, group-parallel and nested, each held against the world of
    one. Returns the path's launches (each rank's, summed over the optimizers) and
    the measurements."""
    import torch.distributed as dist

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(f"phase 16 multi-process runs on {smi}; kinematics samples a heliostat: {DISTRIBUTED_KINEMATICS_SAMPLES} "
         f"({'no cut' if DISTRIBUTED_KINEMATICS_SAMPLES == KINEMATICS['samples'] else 'cut from ' + str(KINEMATICS['samples'])})")
    # Every check's failure is collected and raised at the phase's end, after every gap is printed.
    failures: list[str] = []
    world_one: dict = {}
    for groups in (2, 1):
        plain = {name: run_distributed(device, name, groups, None, data) for name in DISTRIBUTED_OPTIMIZERS}
        with setup_distributed_environment(groups, num_processes=1, device="cuda") as setup:
            if dist.get_backend() != "nccl" or setup.is_distributed:
                raise AssertionError(f"phase 16: the world of one is {dist.get_backend()}, {setup}")
            probe = torch.arange(4.0, device=device)
            dist.all_reduce(probe)
            gathered = [None]
            dist.all_gather_object(gathered, {"rank": setup.rank})
            if not (torch.equal(probe, torch.arange(4.0, device=device)) and gathered == [{"rank": 0}]):
                raise AssertionError(f"phase 16: NCCL world of one gave {probe}, {gathered}")
            nccl = {name: run_distributed(device, name, groups, setup, data) for name in DISTRIBUTED_OPTIMIZERS}
        world_one[groups] = {"plain": plain, "nccl": nccl}
        for name in DISTRIBUTED_OPTIMIZERS:
            for label, run in (("without a setup", plain[name]), ("NCCL world of one", nccl[name])):
                if run["launches"] != run["expected_launches"]:
                    failures.append(f"phase 16 {name}, {groups} group(s), {label}: launched {run['launches']}, "
                                    f"expected {run['expected_launches']}")
            gaps = distributed_gaps(nccl[name], plain[name])
            limits = distributed_limits(name, NESTED_TOLERANCE)
            _log(f"phase 16 {name}, {groups} group(s), world of one: without a setup {describe_run(plain[name])}; "
                 f"NCCL setup {describe_run(nccl[name])}; gaps {json.dumps(gaps)}, limits {json.dumps(limits)}")
            failures += distributed_gap_failures(f"NCCL world of one, {groups} group(s)", name, gaps, limits)
    start = time.perf_counter()
    ranks = world_of_two(data)
    spawned = time.perf_counter() - start
    result = dict(world_one=world_one, ranks=ranks, world_of_two_seconds=spawned)
    for mode, groups, tolerance in (("group_parallel", 2, GROUP_PARALLEL_TOLERANCE), ("nested", 1, NESTED_TOLERANCE)):
        for name in DISTRIBUTED_OPTIMIZERS:
            reference = world_one[groups]["plain"][name]
            for rank, results in enumerate(ranks):
                run = results[mode][name]
                if run["launches"] != run["expected_launches"]:
                    failures.append(f"phase 16 {mode} {name} rank {rank}: launched {run['launches']}, "
                                    f"expected {run['expected_launches']}")
            gaps = [distributed_gaps(results[mode][name], reference) for results in ranks]
            between = distributed_gaps(ranks[1][mode][name], ranks[0][mode][name])
            limits = distributed_limits(name, tolerance)
            _log(f"phase 16 {mode} {name}: world of one {describe_run(reference)}; "
                 + "; ".join(f"rank {rank} {describe_run(results[mode][name])}, launches "
                             f"{ {k: v for k, v in results[mode][name]['launches'].items() if v} }"
                             for rank, results in enumerate(ranks))
                 + f"; gaps to the world of one {json.dumps(gaps)}, limits {json.dumps(limits)}, between the ranks "
                   f"{json.dumps(between)}")
            for rank_gaps in gaps:
                failures += distributed_gap_failures(mode, name, rank_gaps, limits)
            if any(between.values()):
                failures.append(f"phase 16 {mode} {name}: the ranks disagree {between}")
    _log(f"phase 16 world of two: spawned, ran and joined in {spawned:.3f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    for mode in ("group_parallel", "nested"):
        for rank, results in enumerate(ranks):
            result[f"{mode}_rank{rank}"] = {"launches": {
                kernel: sum(run["launches"][kernel] for run in results[mode].values()) for kernel in KERNELS
            }}
    return result


MAIN_PATH = {
    "blocking_sigma_forward": "aim_point",
    "blocking_sigma_backward": "aim_point",
    "splat_dynamic_window_forward": "surface_step_block_window",
    "splat_dynamic_window_backward": "surface_step_block_window",
    "splat_window_2d_forward": "formulation_tool",
    "splat_band_forward": "formulation_tool",
    "lbvh_traverse": "plant_lbvh",
}
# The formulation tool's errors against the full splat's plain version, relative
# to the peak: at most the summation bound 2 (n - 1) u of the fullest pixel's
# ~4,000 deposits (5e-4); phase 3e holds both kernels per pixel.
TOOL_MAX_REL_ERR = 1e-3


def drive_formulation_tool(device: torch.device) -> dict:
    """Phase 11: the splat-formulation tool at its full shape; its launch counts."""
    reset_launch_counts()
    result = splat_formulation_bench.run(device)
    launches = launch_counts()
    _log(f"phase 11 formulation tool: {json.dumps(result)}; launches {launches}")
    for name in ("window_2d_max_rel_err", "band_accumulate_max_rel_err"):
        if not result[name] <= TOOL_MAX_REL_ERR:
            raise AssertionError(f"phase 11: {name} {result[name]} > {TOOL_MAX_REL_ERR}")
    if not (launches["splat_window_2d_forward"] and launches["splat_band_forward"]):
        raise AssertionError(f"phase 11: a kernel of the tool did not launch ({launches})")
    return dict(launches=launches, **result)


# --------------------------------------------------------------------------- #
# Data ingress (phase 15): STRAL deflectometry fitted to NURBS on the card, the
# fits assembled into a heliostat group by the scenario loader, and rendered.
# --------------------------------------------------------------------------- #

# examples/paint_plots: the three heliostats_for_raytracing of paint_plot_config.yaml,
# the fit of flux_prediction_scenario.py:104-111 (20 x 20 control points, degrees 3,
# every 100th point, the normals, lr 1e-3, tolerance 1e-10, max_epoch 400) and the
# trace of flux_prediction_raytracing.py:48-49 (256 x 256 pixels, 1,000 rays a point)
# at the loader's default 50 x 50 points a facet. 80,000 points a facet is this
# phase's own choice. The gates: the last fit loss below the first by loss_factor;
# the mean angle between the fitted and the analytic normals at every 8th point of
# the cloud below mean_angle (rad); the fitted and the analytic fluxes within flux_l1
# (relative L1). The last is loose for a reason: 800 points a facet leave the border
# of each facet's NURBS unconstrained, and its outer rows and columns of samples, 8% of
# the points, lie several times further from the analytic normals than the rest
# (phase 15b prints both means).
INGRESS_HELIOSTATS = ("AA39", "AY26", "BC34")
INGRESS = dict(
    facet_points=80_000, control_points=(20, 20), step=100, max_epoch=400, surface_points=(50, 50),
    rays=1000, bitmap=(256, 256), ray_chunk=None, loss_factor=100.0, mean_angle=5e-4, flux_l1=0.25,
)
INGRESS_FIT = dict(initial_learning_rate=1e-3, fit_method=constants.fit_nurbs_from_normals, tolerance=1e-10)
INGRESS_FOCAL_LENGTH = 50.0  # m, the paraboloid z = (e^2 + n^2) / (4 f)
INGRESS_DENT = (1.5e-3, 0.25)  # m: the amplitude and width of each heliostat's Gaussian dent
# A fit on the card against the same fit on the CPU. Adam's steps of +-lr part two
# fp32 (or an fp32 and an fp64) trajectories once the loss nears 1e-9, around epoch
# 90, after which their losses wander within a factor ~2 of each other. So: the same
# epochs, the first CPU_FIT_EARLY_EPOCHS losses within CPU_FIT_EARLY_RTOL (relative),
# the last losses within a factor CPU_FIT_LAST_LOSS_FACTOR, and the normals on the
# loader's grid within CPU_FIT_NORMAL_MEAN_ANGLE (rad) on average.
# tests/test_torch_surface_generator.py holds the port's CPU fit to the JAX package's
# at this configuration to the same bounds.
CPU_FIT_EARLY_EPOCHS = 50
CPU_FIT_EARLY_RTOL = 1e-4
CPU_FIT_LAST_LOSS_FACTOR = 4.0
CPU_FIT_NORMAL_MEAN_ANGLE = 3e-4
# The 4 facets of a 3.2 x 2.56 m concentrator (the synthetic field's, AA39-like).
INGRESS_FACET_HALF = (0.8025, 0.6375)
INGRESS_FACET_SIGNS = ((-1, 1), (1, 1), (-1, -1), (1, -1))


def ingress_facets() -> tuple[np.ndarray, np.ndarray]:
    """Facet translations ``[4, 4]`` and canting vectors ``[4, 2, 4]``."""
    half_e, half_n = INGRESS_FACET_HALF
    translations = np.zeros((4, 4), np.float32)
    canting = np.zeros((4, 2, 4), np.float32)
    for i, (sign_e, sign_n) in enumerate(INGRESS_FACET_SIGNS):
        translations[i, :3] = (sign_e * 0.8075, sign_n * 0.6425, 0.0402)
        canting[i, 0, :3] = (half_e, 0.0, -sign_e * 4.98e-3)
        canting[i, 1, :3] = (0.0, half_n, -sign_n * 3.15e-3)
    return translations, canting


def dented_paraboloid(e: np.ndarray, n: np.ndarray, dent: tuple[float, float]) -> tuple[np.ndarray, np.ndarray]:
    """Height ``[N]`` and unit normals ``[N, 3]`` (float64) at heliostat-frame (e, n): the
    paraboloid of focal length INGRESS_FOCAL_LENGTH plus a Gaussian dent centred at ``dent``."""
    amplitude, width = INGRESS_DENT
    f = INGRESS_FOCAL_LENGTH
    bump = amplitude * np.exp(-((e - dent[0]) ** 2 + (n - dent[1]) ** 2) / (2 * width**2))
    z = (e**2 + n**2) / (4 * f) + bump
    slope_e = e / (2 * f) - bump * (e - dent[0]) / width**2
    slope_n = n / (2 * f) - bump * (n - dent[1]) / width**2
    normals = np.stack([-slope_e, -slope_n, np.ones_like(e)], axis=-1)
    return z, normals / np.linalg.norm(normals, axis=-1, keepdims=True)


def ingress_dents(count: int) -> np.ndarray:
    """Each heliostat's dent centre ``[count, 2]`` (m), from the seed."""
    rng = np.random.RandomState(SEED + 15)
    return np.stack([rng.uniform(-1.2, 1.2, count), rng.uniform(-0.9, 0.9, count)], axis=1)


def facet_local_surface(e: np.ndarray, n: np.ndarray, facet: int, dent) -> tuple[np.ndarray, np.ndarray]:
    """The dented paraboloid in facet ``facet``'s frame: points ``[N, 3]`` about its
    centre (height 0 there) and normals ``[N, 3]``, float64."""
    translations, _ = ingress_facets()
    te, tn = float(translations[facet, 0]), float(translations[facet, 1])
    z, normals = dented_paraboloid(e + te, n + tn, dent)
    centre, _ = dented_paraboloid(np.array([te]), np.array([tn]), dent)
    return np.stack([e, n, z - centre[0]], axis=-1), normals


def write_stral(path, translations: np.ndarray, canting: np.ndarray, points: list, normals: list) -> None:
    """A STRAL deflectometry binary: the surface header (a 2 x 2 facet grid), then per
    facet its header (translation, canting vectors, point count) and its records of
    point, normal and one unused float, the layout ``io/stral.py`` reads."""
    import struct

    with open(path, "wb") as file:
        file.write(struct.pack("=5f2I2f", 1.0, 2.0, 3.0, 4.0, 5.0, 2, 2, 0.1, 0.2))
        for i, (p, nrm) in enumerate(zip(points, normals)):
            file.write(
                struct.pack("=i9fI", i, *translations[i, :3], *canting[i, 0, :3], *canting[i, 1, :3], p.shape[0])
            )
            records = np.concatenate([p, nrm, np.zeros((p.shape[0], 1))], axis=1).astype(np.float32)
            file.write(records.tobytes())


def write_ingress_stral(path, heliostat: int, facet_points: int, dent) -> None:
    """Heliostat ``heliostat``'s STRAL file: ``facet_points`` points a facet, uniform on
    each facet from the seed, on the dented paraboloid."""
    rng = np.random.RandomState(SEED + 150 + heliostat)
    translations, canting = ingress_facets()
    half_e, half_n = INGRESS_FACET_HALF
    points, normals = [], []
    for facet in range(4):
        e = rng.uniform(-half_e, half_e, facet_points)
        n = rng.uniform(-half_n, half_n, facet_points)
        p, nrm = facet_local_surface(e, n, facet, dent)
        points.append(p)
        normals.append(nrm)
    write_stral(path, translations, canting, points, normals)


def counted_syncs(fn, device: torch.device):
    """``fn()`` and the synchronising CUDA calls it made, as torch's sync debug mode
    warns of them (None on the CPU)."""
    if device.type != "cuda":
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in caught)


def fit_stral_heliostat(device: torch.device, name: str, cloud, size: dict) -> dict:
    """``generate_fitted_surface_config`` of one STRAL cloud on ``device``, timed, with
    its loss history and host syncs."""
    generator = SurfaceGenerator(number_of_control_points=size["control_points"], degrees=(3, 3))
    translations, canting, points, normals = cloud

    def fit():
        return generator.generate_fitted_surface_config(
            heliostat_name=name, facet_translation_vectors=translations, canting=canting,
            surface_points_with_facets_list=points, surface_normals_with_facets_list=normals,
            deflectometry_step_size=size["step"], max_epoch=size["max_epoch"], device=device, **INGRESS_FIT,
        )

    synchronize(device)
    start = time.perf_counter()
    surface, syncs = counted_syncs(fit, device)
    seconds = time.perf_counter() - start
    history = np.asarray(generator.loss_history)
    return dict(surface=surface, history=history, seconds=seconds, syncs=syncs)


def fit_parameters(points: list[np.ndarray], step: int, every: int) -> tuple[np.ndarray, np.ndarray]:
    """Every ``every``-th point of each facet's cloud ``[F, N', 3]`` and its NURBS
    parameters ``[F, N', 2]``: its (e, n) normalised by the fit's own normalisation (the
    extent of every ``step``-th point), clipped into the open unit square."""
    count = min(p.shape[0] for p in points)
    cloud = np.stack([p[:count] for p in points])
    fitted = cloud[:, ::step, :2]
    low = fitted.min(axis=1, keepdims=True)
    extent = fitted.max(axis=1, keepdims=True) - low
    parameters = (cloud[:, ::every, :2] - low + 1e-5) / (extent + 2e-5)
    return cloud[:, ::every], np.clip(parameters, 1e-6, 1 - 1e-6)


def surface_normals_at(surface, parameters: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fitted surface's normals ``[F, N, 3]`` at NURBS parameters ``[F, N, 2]``."""
    control_points = torch.tensor(np.stack([f.control_points for f in surface.facet_list]), device=device)
    degrees = tuple(int(d) for d in surface.facet_list[0].degrees)
    _, normals = evaluate_nurbs_surfaces(
        control_points[None], degrees, torch.tensor(parameters, dtype=torch.float32, device=device)[None]
    )
    return normals[0, ..., :3]


def angles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angles (rad) between vectors ``[..., 3]``, in float64 as atan2(|a x b|, a . b),
    which stays exact near 0 where arccos of an fp32 unit vector's dot does not."""
    a, b = a.double(), b.double()
    return torch.atan2(torch.linalg.vector_norm(torch.linalg.cross(a, b, dim=-1), dim=-1), torch.sum(a * b, dim=-1))


def fit_gaps(fit: dict, other: dict, surface_points: tuple[int, int]) -> dict:
    """How far two fits of one cloud (:func:`fit_stral_heliostat`) are apart: their epochs,
    the largest relative gap of their first CPU_FIT_EARLY_EPOCHS losses, the ratio of
    their last losses (the larger over the smaller), and the mean and largest angle
    between their normals on the loader's grid."""
    first, second = fit["history"], other["history"]
    early = min(CPU_FIT_EARLY_EPOCHS, len(first), len(second))
    grid = create_nurbs_evaluation_grid(surface_points, device="cpu").numpy()
    grid = np.broadcast_to(grid, (len(fit["surface"].facet_list),) + grid.shape)
    normal_angles = angles(surface_normals_at(fit["surface"], grid, torch.device("cpu")),
                           surface_normals_at(other["surface"], grid, torch.device("cpu")))
    return dict(
        epochs=[len(first), len(second)],
        early_rtol=float(np.max(np.abs(first[:early] - second[:early]) / np.abs(second[:early]))),
        last_loss_ratio=float(max(first[-1], second[-1]) / min(first[-1], second[-1])),
        normal_mean_angle=float(normal_angles.mean()),
        normal_max_angle=float(normal_angles.max()),
    )


def check_fit_gaps(label: str, gaps: dict) -> None:
    """Raise unless :func:`fit_gaps` lie within the CPU_FIT_* bounds."""
    if not (gaps["epochs"][0] == gaps["epochs"][1] and gaps["early_rtol"] <= CPU_FIT_EARLY_RTOL
            and gaps["last_loss_ratio"] <= CPU_FIT_LAST_LOSS_FACTOR
            and gaps["normal_mean_angle"] <= CPU_FIT_NORMAL_MEAN_ANGLE):
        raise AssertionError(f"{label}: {gaps}")


def ingress_scenario_image(surfaces: list, positions: np.ndarray) -> dict:
    """The prototype and heliostat sections of a scenario file holding the fitted
    ``surfaces`` (one a heliostat, named INGRESS_HELIOSTATS) at ``positions``, with the
    default kinematics and tutorial 00b's AA39-like linear actuators as prototypes."""
    actuators = generate_scenario_from_stral.stral_actuators()
    prototype = PrototypeConfig(
        surface_prototype=surfaces[0], kinematics_prototype=KinematicsConfig(), actuators_prototype=actuators
    )
    heliostats = [
        HeliostatConfig(name=name, heliostat_id=i, position=positions[i], surface=surface)
        for i, (name, surface) in enumerate(zip(INGRESS_HELIOSTATS, surfaces))
    ]
    return {
        constants.prototype_key: prototype.create_prototype_dict(),
        constants.heliostat_key: {h.name: h.create_heliostat_dict() for h in heliostats},
    }


def analytic_group_surfaces(clouds: list, dents: np.ndarray, step: int, surface_points: tuple[int, int],
                            device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The analytic (dented paraboloid) surfaces of the fitted heliostats at the loader's
    sampling grid, mapped onto each facet as the fit maps its parameters (the extent of
    every ``step``-th point of its cloud) and translated as the fitted control points
    are: points and normals ``[H, F * P, 4]`` on ``device``."""
    grid = create_nurbs_evaluation_grid(surface_points, device="cpu").double().numpy()
    translations, _ = ingress_facets()
    all_points, all_normals = [], []
    for (_, _, points, _), dent in zip(clouds, dents):
        count = min(p.shape[0] for p in points)
        heliostat_points, heliostat_normals = [], []
        for facet, p in enumerate(points):
            fitted = p[:count:step, :2].astype(np.float64)
            low, high = fitted.min(axis=0), fitted.max(axis=0)
            e = low[0] + grid[:, 0] * (high[0] - low[0])
            n = low[1] + grid[:, 1] * (high[1] - low[1])
            local, normals = facet_local_surface(e, n, facet, dent)
            heliostat_points.append(np.concatenate([local + translations[facet, :3], np.ones((len(e), 1))], axis=1))
            heliostat_normals.append(np.concatenate([normals, np.zeros((len(e), 1))], axis=1))
        all_points.append(np.concatenate(heliostat_points))
        all_normals.append(np.concatenate(heliostat_normals))
    return tuple(torch.tensor(np.stack(x), dtype=torch.float32, device=device) for x in (all_points, all_normals))


def ingress_alignment(group, tower: SolarTower):
    """Target 0 for every heliostat, light from the south horizon, and the group's
    surfaces aligned to the target's centre: (targets, incident directions, points,
    normals)."""
    device = group.positions.device
    num = group.number_of_heliostats
    targets = torch.zeros(num, dtype=torch.long, device=device)
    incident = torch.tensor([0.0, 1.0, 0.0, 0.0], device=device).expand(num, 4)
    points, normals = hg.align_surfaces_with_incident_ray_directions(
        group, get_centers_of_target_areas(tower, targets), incident
    )[:2]
    return targets, incident, points, normals


@torch.no_grad()
def ingress_render(group, tower: SolarTower, distortions, size: dict) -> torch.Tensor:
    """The group's flux ``[H, height, width]`` from ``trace_rays``."""
    targets, incident, points, normals = ingress_alignment(group, tower)
    return trace_rays(
        tower, points, normals, incident, targets, *distortions,
        config=RenderConfig(bitmap_resolution=size["bitmap"], ray_chunk=size["ray_chunk"]),
    )[0]


@torch.no_grad()
def ingress_rays(group, tower: SolarTower, distortions, size: dict):
    """The splat's inputs of the render's first ray chunk (all rays without chunks),
    ``[H, rays * P]`` each."""
    targets, incident, points, normals = ingress_alignment(group, tower)
    chunk = size["ray_chunk"] or size["rays"]
    rays = ray_splat_inputs(
        tower, geometry.reflect(incident[:, None, :], normals), points, targets,
        distortions[0][:, :chunk], distortions[1][:, :chunk], 1.0,
        RenderConfig(bitmap_resolution=size["bitmap"], ray_chunk=size["ray_chunk"]),
    )
    num = group.number_of_heliostats
    return tuple(x.reshape(num, -1).contiguous() for x in (rays.bitmap_e, rays.bitmap_u, rays.final_intensities))


def ingress_launches(size: dict) -> dict[str, int]:
    """Phase 15's launches: one splat forward a ray chunk in each of its three renders
    (a warm-up and the timed one of the fits, one of the analytic surfaces; no
    gradient, so no backward and no recompute); the fits launch no kernel."""
    chunks = 1 if size["ray_chunk"] is None else size["rays"] // size["ray_chunk"]
    return launches(splat_forward=3 * chunks)


def drive_data_ingress(device: torch.device, size: dict = INGRESS):
    """Phase 15. a: INGRESS_HELIOSTATS' STRAL files written and read back with
    ``extract_stral_deflectometry_data``, each heliostat fitted on ``device`` with
    ``generate_fitted_surface_config`` (timed, its epochs and host syncs), the losses
    finite and falling by ``loss_factor``, the fitted normals at the clouds' points
    within ``mean_angle`` of the analytic ones; the first heliostat also fitted on the
    CPU, where the card's fit must take as many epochs and agree (CPU_FIT_*).
    b: the fits turned into the loader's heliostat records by ``_read_heliostats`` on
    their scenario image, one group assembled on ``device`` by
    ``_assemble_heliostat_groups`` (``sample_surface`` at ``surface_points``), traced
    with ``trace_rays`` (``rays`` a point onto ``bitmap``; a warm-up, then timed), and
    so the analytic surfaces at the same grid; the fluxes finite, non-zero and within
    ``flux_l1``; the launches those of :func:`ingress_launches`. Returns the path's
    numbers, the group, the tower and the render's distortions."""
    names = INGRESS_HELIOSTATS
    dents = ingress_dents(len(names))
    synchronize(device)
    reset_launch_counts()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        clouds = []
        for i, name in enumerate(names):
            path = pathlib.Path(directory) / f"{name}.binp"
            write_ingress_stral(path, i, size["facet_points"], dents[i])
            clouds.append(extract_stral_deflectometry_data(path))
    read_seconds = time.perf_counter() - start
    fits = [fit_stral_heliostat(device, name, cloud, size) for name, cloud in zip(names, clouds)]

    synthetic = make_synthetic_scenario(
        number_of_heliostats=len(names), number_of_surface_points_per_facet=(2, 2), device=device
    )
    positions, tower = synthetic.heliostat_groups[0].positions.cpu().numpy(), synthetic.solar_tower
    synchronize(device)
    start = time.perf_counter()
    records = _read_heliostats(InMemoryGroup(ingress_scenario_image([f["surface"] for f in fits], positions)))
    (group,), group_names = _assemble_heliostat_groups(records, size["surface_points"], None, device)
    synchronize(device)
    assembly_seconds = time.perf_counter() - start

    sun = Sun(number_of_rays=size["rays"])
    generator = torch.Generator(device=device).manual_seed(SEED + 15)
    distortions = sun.get_distortions(generator, group.surface_points.shape[1], len(names))
    ingress_render(group, tower, distortions, size)  # warm-up: the first render pays the allocations
    reset_peak_memory(device)
    synchronize(device)
    start = time.perf_counter()
    flux = ingress_render(group, tower, distortions, size)
    synchronize(device)
    render_seconds = time.perf_counter() - start
    peak = max_memory(device)
    points, normals = analytic_group_surfaces(clouds, dents, size["step"], size["surface_points"], device)
    analytic = ingress_render(group.replace(surface_points=points, surface_normals=normals), tower, distortions, size)
    synchronize(device)
    counts = launch_counts()

    phase = "phase 15"
    expected = ingress_launches(size)
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"{phase} launched {counts}, expected {expected}")
    normal_angles = []
    for i, (fit, cloud) in enumerate(zip(fits, clouds)):
        history = fit["history"]
        if not (len(history) and np.isfinite(history).all()):
            raise AssertionError(f"{phase}a {names[i]}: losses {history}")
        if not history[-1] * size["loss_factor"] < history[0]:
            raise AssertionError(f"{phase}a {names[i]}: loss {history[0]} -> {history[-1]}, not by {size['loss_factor']}")
        cloud_points, parameters = fit_parameters(cloud[2], size["step"], 8)
        fitted_normals = surface_normals_at(fit["surface"], parameters, device)
        analytic_normals = torch.tensor(
            np.stack([facet_local_surface(p[:, 0].astype(np.float64), p[:, 1].astype(np.float64), f, dents[i])[1]
                      for f, p in enumerate(cloud_points)]),
            device=device,
        )
        normal_angles.append(float(angles(fitted_normals, analytic_normals).mean()))
        if not normal_angles[-1] < size["mean_angle"]:
            raise AssertionError(f"{phase}a {names[i]}: fitted normals {normal_angles[-1]} rad from the analytic ones")
    if not (torch.isfinite(flux).all() and torch.isfinite(analytic).all() and float(flux.sum()) > 0):
        raise AssertionError(f"{phase}b: flux not finite or all zero")
    flux_l1 = float((flux - analytic).abs().sum() / analytic.abs().sum())
    # Where the fluxes part: the fitted normals on the sampling grid, each facet's border
    # row and column against its interior.
    grid_angles = angles(group.surface_normals[..., :3], normals[..., :3]).reshape(
        len(names), -1, *size["surface_points"]
    )
    border = torch.ones(size["surface_points"], dtype=torch.bool, device=device)
    border[1:-1, 1:-1] = False
    grid_border_angle, grid_interior_angle = (float(grid_angles[..., m].mean()) for m in (border, ~border))
    if not flux_l1 < size["flux_l1"]:
        raise AssertionError(f"{phase}b: fitted and analytic fluxes {flux_l1} apart (relative L1)")

    cpu = fit_stral_heliostat(torch.device("cpu"), names[0], clouds[0], size)
    gaps = fit_gaps(fits[0], cpu, size["surface_points"])
    check_fit_gaps(f"{phase}a {names[0]} on {device} against the cpu", gaps)

    rays = len(names) * size["rays"] * group.surface_points.shape[1]
    result = dict(
        launches=counts,
        fit_seconds=[f["seconds"] for f in fits],
        epochs=[len(f["history"]) for f in fits],
        syncs=[f["syncs"] for f in fits],
        first_losses=[float(f["history"][0]) for f in fits],
        last_losses=[float(f["history"][-1]) for f in fits],
        normal_mean_angles=normal_angles,
        cpu_fit_seconds=cpu["seconds"],
        cpu_gaps=gaps,
        read_seconds=read_seconds,
        assembly_seconds=assembly_seconds,
        render_seconds=render_seconds,
        rays=rays,
        rays_per_s=rays / render_seconds,
        max_memory_allocated=peak,
        flux_l1=flux_l1,
        grid_border_angle=grid_border_angle,
        grid_interior_angle=grid_interior_angle,
        group_names=group_names,
        surfaces=[f["surface"] for f in fits],
    )
    _log(
        f"{phase}a data ingress: {len(names)} STRAL files of 4 x {size['facet_points']} points written and read in "
        f"{read_seconds:.3f} s; fits at {size['control_points']} control points, every {size['step']}th point, "
        f"max_epoch {size['max_epoch']} on {device}: "
        + "; ".join(
            f"{name} {f['seconds']:.3f} s, {len(f['history'])} epochs ({len(f['history']) / f['seconds']:.1f}/s), "
            f"{f['syncs']} host syncs, loss {f['history'][0]:.4g} -> {f['history'][-1]:.4g}, normals {a:.3g} rad "
            "from the analytic"
            for name, f, a in zip(names, fits, normal_angles)
        )
        + f"; {names[0]} on the cpu {cpu['seconds']:.3f} s against {device}: {json.dumps(gaps)}"
    )
    _log(
        f"{phase}b data ingress: one group ({group_names}) assembled on {device} in {assembly_seconds:.3f} s at "
        f"{size['surface_points']} points a facet; render of {rays} rays ({size['rays']} a point, ray chunks "
        f"{size['ray_chunk'] or 'none'}) onto {size['bitmap']} in {render_seconds:.4f} s, "
        f"{result['rays_per_s']:.4g} rays/s, peak {peak} bytes; fitted against analytic flux {flux_l1:.4g} "
        f"(relative L1), the fitted normals on the grid {grid_border_angle:.3g} rad from the analytic on the facets' "
        f"border rows and columns ({border.double().mean():.3g} of the points), {grid_interior_angle:.3g} inside "
        f"(means); launches {counts}"
    )
    return result, group, tower, distortions


def check_ingress_kernels(group, tower: SolarTower, distortions, size: dict = INGRESS) -> dict[str, dict]:
    """Phase 15c: the splat forward at the render's shape (``[3, 10 M]`` rays onto
    ``[3, 256, 256]``) against its plain version, timed beside ``index_add_`` and its
    bound. Returns its timings under "data_ingress"."""
    height, width = size["bitmap"][1], size["bitmap"][0]
    rays = ingress_rays(group, tower, distortions, size)
    error, share = check_forward(
        "splat_forward", splat_forward_cuda(*rays, height, width), splat_forward_plain(*rays, height, width),
        rays, height, width,
    )
    timings, work = time_splat_pair(rays, None, height, width, iterations=5)
    t = timings["splat_forward"]
    shape = list(rays[0].shape)
    _log(
        f"phase 15c splat forward at the render's shape: {shape} rays ({work['valid']} valid, {work['touched']} "
        f"pixels touched) -> [{shape[0]}, {height}, {width}], max_abs_err {error:.3g} ({share:.3g} of its tolerance), "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} ms, bound "
        f"{t['bound'][0]:.4f} ms ({t['bound'][1]})"
    )
    return {"splat_forward": {"data_ingress": dict(
        shape=shape, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], max_abs_err=error,
    )}}


# --------------------------------------------------------------------------- #
# Phase 17: the entry points (tutorials, the field-optimization pipeline, the tools).
# --------------------------------------------------------------------------- #

PAINT_POWER_PLANT = (50.91342112259258, 6.387824755874856, 87.0)
# The tutorials' field: the synthetic field's receiver (8 m x 7 m, centred 45 m up, 3 m
# south of the tower's foot) and four heliostats with AA39's actuators on a grid north of
# it, from which each aims at the receiver with the sun in the south.
PAINT_RECEIVER = ((0.0, -3.0, 45.0), 8.0, 7.0)
TUTORIAL_HELIOSTATS = ("AA39", "AB40", "AC41", "AD42")
TUTORIAL_PLACES = ((-8.0, 40.0), (8.0, 40.0), (-8.0, 56.0), (8.0, 56.0))  # east, north (m)
TUTORIAL_RAYS = 100  # the light source tutorial 00a writes
TUTORIAL_SAMPLES = 3  # calibration samples a heliostat, as tutorials 03 and 04 read of AA39
# Tutorial 01 on the card against the CPU: the fp32 geometry's gap is ~1.3e-4 of the peak.
TUTORIAL_FLUX_SHARE = 2e-4
AA39_ACTUATOR = dict(increment=154166.67, initial_stroke_length=0.075, offset=0.34, pivot_radius=0.32,
                     initial_angle=0.5)
# Phase 17b: the pipeline at config.yaml's widths on phase 13's field; the surface and
# aim-point stages' max_epoch cut from 300 (PERF.md §4).
PIPELINE_EPOCHS = dict(surface=10, aim_point=10)
PIPELINE_SURFACE_RAY_CHUNK = 12  # phase 12's: 180 rays a point in 15 checkpointed chunks
PIPELINE_STAGES = ("kinematics", "surface", "aim_point")
# Each stage's files, with the JAX pipeline's names and keys (generate_results.py:121-134,188-197,261-291).
PIPELINE_FILES = {
    "kinematics": {
        "kinematics_reconstruction.npz": {"final_loss", "group_0_rotation_deviations"},
        "kinematics_loss_history.json": {"group_0"},
    },
    "surface": {
        "surface_reconstruction.npz": {"final_loss", "group_0_control_points"},
        "surface_loss_history.json": {"group_0"},
    },
    "aim_point": {
        "aim_point_optimization.npz": {"final_loss", "intercepts", "on_targets", "blockings",
                                       "group_0_motor_positions"},
        "aim_point_loss_history.json": {"total_loss", "flux_loss", "flux_integral", "flux_integral_constraint",
                                        "intercept_constraint", "local_flux_constraint"},
    },
}
SPREAD_RUNS = ("production_1", "production_2", "deterministic")
ABLATE_STEPS = 5  # timed calls of each of ablate_step's variants
MEMORY_REPORT = dict(heliostats=4000, rays=2, surface_points=50, blocking=True)  # phase 14a's field
MEMORY_REPORT_CHUNK = 500


def paint_wgs84(east: float, north: float, up: float) -> list[float]:
    """WGS84 (latitude, longitude, altitude) of the point ``(east, north, up)`` m from
    :data:`PAINT_POWER_PLANT`, linearised."""
    return [PAINT_POWER_PLANT[0] + north / 111_200.0, PAINT_POWER_PLANT[1] + east / 70_100.0,
            PAINT_POWER_PLANT[2] + up]


def write_paint_tower(path: pathlib.Path) -> pathlib.Path:
    """A PAINT tower-measurements JSON with one planar target area, ``receiver``
    (:data:`PAINT_RECEIVER`), facing north."""
    (east, north, up), width, height = PAINT_RECEIVER
    corners = {
        f"{v}_{h}": paint_wgs84(east + sign_e * width / 2, north, up + sign_u * height / 2)
        for v, sign_u in (("upper", 1), ("lower", -1)) for h, sign_e in (("left", -1), ("right", 1))
    }
    path.write_text(json.dumps({
        "power_plant_properties": {"coordinates": list(PAINT_POWER_PLANT)},
        "receiver": {
            "type": "planar",
            "coordinates": {"center": paint_wgs84(east, north, up), **corners},
            "normal_vector": [0.0, 1.0, 0.0],
        },
    }))
    return path


def write_paint_heliostat(path: pathlib.Path, east: float, north: float, seed: int) -> pathlib.Path:
    """A PAINT heliostat-properties JSON: the heliostat at ``(east, north)``, 1.7 m up,
    phase 15's four canted facets, joint deviations of about a mm and AA39's linear
    actuators (each parameter off by about 0.1%), from ``seed``."""
    rng = np.random.RandomState(seed)
    translations, canting = ingress_facets()
    path.write_text(json.dumps({
        "heliostat_position": paint_wgs84(east, north, 1.7),
        "facet_properties": {
            "number_of_facets": 4,
            "facets": [
                {"translation_vector": translations[i, :3].tolist(), "canting_e": canting[i, 0, :3].tolist(),
                 "canting_n": canting[i, 1, :3].tolist()}
                for i in range(4)
            ],
        },
        "kinematics_properties": {
            **{key: float(rng.normal(0, 1e-3)) for key in paint_scenario_parser._DEVIATION_KEYS.values()},
            "actuators": [
                {"type_axis": "linear", "clockwise_axis_movement": i, "min_increment": 0, "max_increment": 70000,
                 **{key: value * (1 + rng.normal(0, 1e-3)) for key, value in AA39_ACTUATOR.items()}}
                for i in range(2)
            ],
        },
        "initial_orientation": [0.0, -1.0, 0.0],
    }))
    return path


def tutorial_scenario(directory: pathlib.Path, names, surface_points: tuple[int, int], device,
                      control_points: tuple[int, int] | None = None):
    """Tutorial 00a's scenario of the heliostats ``names`` in ``directory``, loaded from its
    image in memory onto ``device`` (no HDF5 file)."""
    generator = generate_scenario_from_paint.paint_scenario_generator(
        directory / "tower-measurements.json",
        [(name, directory / f"{name}-heliostat-properties.json") for name in names],
        directory / "scenario.h5",
        number_of_rays=TUTORIAL_RAYS,
    )
    return load_scenario_from_image(generator.scenario_image(), surface_points, control_points, device)


def validations(epochs: list[int], max_epoch: int, log_step: int, stopped: bool) -> int:
    """The validations of a reconstructor's loop that ran ``epochs``: where ``epoch %
    log_step == 0`` (``log_step`` 0 meaning ``max_epoch``), at ``max_epoch - 1`` and at an
    early stop."""
    log_step = log_step or max_epoch
    return sum(
        1 for epoch in epochs
        if epoch % log_step == 0 or epoch == max_epoch - 1 or (stopped and epoch == epochs[-1])
    )


def surface_loop_launches(epochs: list[int], max_epoch: int, log_step: int, stopped: bool,
                          chunks: int | None = None) -> dict[str, int]:
    """The launches of a ``reconstruct_surfaces`` call that ran ``epochs``: the reference
    integrals' forward, each epoch's forward and backward, each validation's forward;
    with ray ``chunks``, each of them a chunk, and each epoch's forward twice (the
    checkpoint's recompute)."""
    count = validations(epochs, max_epoch, log_step, stopped)
    if chunks is None:
        return launches(splat_forward=1 + len(epochs) + count, splat_backward=len(epochs))
    return launches(splat_forward=chunks * (1 + 2 * len(epochs) + count), splat_backward=chunks * len(epochs))


def aim_point_loop_launches(epochs: int, candidates: int | None = AIM_CANDIDATES) -> dict[str, int]:
    """The launches of an ``optimize`` call of ``epochs`` epochs, no heliostat chunks."""
    return {
        name: AIM_LAUNCHES_PER_CALL[candidates][name] + epochs * AIM_LAUNCHES_PER_EPOCH[candidates][name]
        for name in KERNELS
    }


class EpochRecorder:
    """An ``on_epoch`` callback: the epochs a loop ran and the times they ended."""

    def __init__(self):
        self.epochs: list[int] = []
        self.ends: list[float] = []

    def __call__(self, epoch: int, loss: float) -> None:
        self.epochs.append(epoch)
        self.ends.append(time.perf_counter())


def run_entry_point(device: torch.device, label: str, fn, expected) -> dict:
    """``fn(recorder)`` timed between synchronised ends, with its peak memory, launches
    and epochs; ``expected(recorder, result)`` gives the launches it must show on the card."""
    recorder = EpochRecorder()
    synchronize(device)
    reset_peak_memory(device)
    reset_launch_counts()
    start = time.perf_counter()
    result = fn(recorder)
    synchronize(device)
    seconds = time.perf_counter() - start
    counts = launch_counts()
    wanted = expected(recorder, result)
    if device.type == "cuda" and counts != wanted:
        raise AssertionError(f"{label} launched {counts}, expected {wanted}")
    # The first epoch carries the loop's set-up; the median of the others is its rate.
    epoch_seconds = np.diff([start] + recorder.ends)[1:]
    return dict(
        result=result,
        seconds=seconds,
        epochs=len(recorder.epochs),
        last_epoch=recorder.epochs[-1] if recorder.epochs else None,
        epoch_seconds_median=float(np.median(epoch_seconds)) if len(epoch_seconds) else None,
        max_memory_allocated=max_memory(device),
        launches=counts,
    )


def falling(label: str, history: list[float]) -> list[float]:
    """``history``'s first and last entries; it must be finite and fall."""
    if len(history) < 2 or not np.isfinite(history).all() or not history[-1] < history[0]:
        raise AssertionError(f"{label}: the loss does not fall: {history}")
    return [history[0], history[-1]]


def report_runs(phase: str, runs: dict[str, dict]) -> None:
    for label, run in runs.items():
        shown = {k: v for k, v in run.items() if k not in ("result", "launches", "seconds", "max_memory_allocated")}
        _log(
            f"{phase} {label}: {run['seconds']:.6f} s, max_memory_allocated {run['max_memory_allocated']} B, launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }, {json.dumps(shown)}"
        )


def drive_tutorials(device: torch.device) -> dict[str, dict]:
    """Phase 17a: tutorials 01-05 at their own widths and epochs, on PAINT-format files
    written here (:func:`write_paint_tower`, :func:`write_paint_heliostat`) whose scenarios
    are loaded from their images onto ``device``; tutorials 03 and 04 on calibration
    samples built on ``device`` from known rotation deviations
    (:func:`kinematics_calibration`). Tutorial 01's flux is held to the same call on the
    CPU with the same distortions; 03-05's losses must fall; every call's launches are
    asserted."""
    runs: dict[str, dict] = {}
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as name:
        directory = pathlib.Path(name)
        write_paint_tower(directory / "tower-measurements.json")
        for i, (heliostat, (east, north)) in enumerate(zip(TUTORIAL_HELIOSTATS, TUTORIAL_PLACES)):
            write_paint_heliostat(directory / f"{heliostat}-heliostat-properties.json", east, north, SEED + 20 + i)

        single = tutorial_scenario(directory, TUTORIAL_HELIOSTATS[:1], single_heliostat_raytracing.SURFACE_POINTS,
                                   device)
        points = single.heliostat_groups[0].surface_points.shape[1]
        distortions = Sun(number_of_rays=TUTORIAL_RAYS).get_distortions(
            torch.Generator(device="cpu").manual_seed(SEED), points, 1
        )
        run = run_entry_point(
            device, "phase 17a tutorial 01",
            lambda recorder: single_heliostat_raytracing.render_single_heliostat(single, distortions, device=device),
            lambda recorder, result: launches(splat_forward=1),
        )
        on_cpu = single_heliostat_raytracing.render_single_heliostat(
            tutorial_scenario(directory, TUTORIAL_HELIOSTATS[:1], single_heliostat_raytracing.SURFACE_POINTS, cpu),
            distortions, device=cpu,
        )
        flux, flux_cpu = run["result"]["flux"].cpu(), on_cpu["flux"]
        gap = float((flux - flux_cpu).abs().max() / flux_cpu.max())
        if not (torch.isfinite(flux).all() and float(flux_cpu.max()) > 0 and gap <= TUTORIAL_FLUX_SHARE):
            raise AssertionError(f"phase 17a tutorial 01: card against CPU {gap} of the flux peak")
        run.update(flux_gap_to_cpu=gap, intercept=float(run["result"]["intercept"][0]))
        runs["tutorial_01"] = run

        field = tutorial_scenario(directory, TUTORIAL_HELIOSTATS, field_raytracing_sharded.SURFACE_POINTS, device)
        run = run_entry_point(
            device, "phase 17a tutorial 02",
            lambda recorder: field_raytracing_sharded.render_field(field, device=device),
            lambda recorder, result: launches(splat_forward=len(field.heliostat_groups)),
        )
        total = run["result"]["total_flux_per_target"]
        if not (torch.isfinite(total).all() and float(total.sum()) > 0):
            raise AssertionError("phase 17a tutorial 02: no finite flux on the targets")
        run.update(mean_intercepts=run["result"]["mean_intercepts"])
        runs["tutorial_02"] = run

        known = known_rotation_deviations(len(TUTORIAL_HELIOSTATS))
        surfaces = tutorial_scenario(directory, TUTORIAL_HELIOSTATS, surface_reconstruction.SURFACE_POINTS, device,
                                     surface_reconstruction.CONTROL_POINTS)
        data = CalibrationDataParser(
            kinematics_calibration(surfaces, known, TUTORIAL_SAMPLES, surface_reconstruction.BITMAP),
            TUTORIAL_HELIOSTATS,
        )
        surface_block = surface_reconstruction.optimization_configuration()[constants.optimization]

        def surface_expected(recorder, result):
            history = result[1][0].loss_history["total_loss"]
            return surface_loop_launches(recorder.epochs, surface_block[constants.max_epoch],
                                         surface_block[constants.log_step], len(history) == len(recorder.epochs) - 1)

        run = run_entry_point(
            device, "phase 17a tutorial 03",
            lambda recorder: surface_reconstruction.reconstruct_surfaces(surfaces, data, device=device,
                                                                         on_epoch=recorder),
            surface_expected,
        )
        history = run["result"][1][0].loss_history
        run.update(flux_loss_ends=falling("phase 17a tutorial 03 (flux loss)", history["flux_loss"]),
                   total_loss_ends=[history["total_loss"][0], history["total_loss"][-1]])
        runs["tutorial_03"] = run

        kinematics = tutorial_scenario(directory, TUTORIAL_HELIOSTATS, kinematics_reconstruction.SURFACE_POINTS, device)
        data = CalibrationDataParser(
            kinematics_calibration(kinematics, known, TUTORIAL_SAMPLES, kinematics_reconstruction.BITMAP),
            TUTORIAL_HELIOSTATS,
        )
        kinematics_block = kinematics_reconstruction.optimization_configuration()[constants.optimization]

        def kinematics_expected(recorder, result):
            stopped = len(result[1][0].loss_history) == len(recorder.epochs) - 1
            return kinematics_launches(ALIGNMENT, recorder.epochs, kinematics_block[constants.max_epoch],
                                       kinematics_block[constants.log_step], stopped)

        run = run_entry_point(
            device, "phase 17a tutorial 04",
            lambda recorder: kinematics_reconstruction.reconstruct_kinematics(kinematics, data, device=device,
                                                                              on_epoch=recorder),
            kinematics_expected,
        )
        deviations = kinematics.heliostat_groups[0].rotation_deviations.cpu().numpy()
        run.update(loss_ends=falling("phase 17a tutorial 04", run["result"][1][0].loss_history),
                   distance_to_known=[float(np.linalg.norm(known)), float(np.linalg.norm(deviations - known))])
        runs["tutorial_04"] = run

        aim = tutorial_scenario(directory, TUTORIAL_HELIOSTATS, aim_point_optimization.SURFACE_POINTS, device)
        run = run_entry_point(
            device, "phase 17a tutorial 05",
            lambda recorder: aim_point_optimization.optimize_aim_points(aim, device=device, on_epoch=recorder),
            lambda recorder, result: aim_point_loop_launches(len(recorder.epochs)),
        )
        run.update(loss_ends=falling("phase 17a tutorial 05", run["result"][1]["total_loss"]),
                   mean_intercept=float(run["result"][2].mean()))
        runs["tutorial_05"] = run
    for run in runs.values():
        del run["result"]
    report_runs("phase 17a", runs)
    return runs


def pipeline_config(directory: pathlib.Path, cut: bool = True) -> dict:
    """The port's ``examples/field_optimizations/config.yaml`` as a dict (the card's
    machine has no PyYAML; ``tests/test_torch_field_optimizations.py`` holds the two
    equal), its paths under ``directory``; with ``cut``, the surface and aim-point
    stages' ``max_epoch`` cut to :data:`PIPELINE_EPOCHS`."""
    config = {
        "data_dir": str(directory / "data"),
        "tower_file_name": "tower-measurements.json",
        "scenarios_dir": str(directory / "scenarios"),
        "results_dir": str(directory / "results"),
        "plots_dir": str(directory / "plots"),
        "maximum_number_of_measurements": 20,
        "random_seed": 7,
        "metadata_root": str(directory),
        "minimum_number_of_measurements": 1,
        "kinematics_reconstruction_image_type": "flux-centered",
        "surface_reconstruction_image_type": "flux-centered",
        "excluded_heliostats_for_reconstruction": [],
        "data_for_stral_dir": str(directory / "data_for_stral"),
        "heliostats": ["AA39"],
        "surface_reconstruction_optimization_configuration": dict(
            max_epoch=300, batch_size=48, number_of_surface_points=50, number_of_control_points=7,
            number_of_rays=180, sample_limit=4, initial_learning_rate=1.0e-4, tolerance=5.0e-4, log_step=25,
            scheduler_type="cyclic", lr_min=1.0e-6, lr_max=1.0e-4, step_size_up=122, early_stopping_delta=1.0,
            early_stopping_patience=10, early_stopping_window=40, energy_tolerance=0.01, rho_flux_integral=1.0,
            weight_smoothness=0.0, weight_ideal_surface=0.1,
        ),
        "kinematics_reconstruction_optimization_configuration": dict(
            method="alignment", max_epoch=500, batch_size=480, sample_limit=20, number_of_rays=19,
            initial_learning_rate_rotation_deviation=3.0e-4, tolerance=5.0e-4, log_step=50,
            scheduler_type="reduce_on_plateau", lr_min=1.0e-6, reduce_factor=0.8, patience=50, threshold=1.0e-3,
            cooldown=5, early_stopping_delta=1.0, early_stopping_patience=10, early_stopping_window=40,
        ),
        "aim_point_optimization_configuration": dict(
            max_epoch=300, batch_size=50, number_of_rays=30, initial_learning_rate=1.0e-3, tolerance=5.0e-4,
            log_step=25, early_stopping_delta=1.0, early_stopping_patience=10, early_stopping_window=40,
            scheduler_type="reduce_on_plateau", lr_min=1.0e-4, reduce_factor=0.9, patience=100, threshold=1.0e-3,
            cooldown=20, rho_flux_integral=1.0, rho_local_flux=1.0, rho_intercept=1.0, max_flux_density=1000000.0,
            dni=800.0, trapezoid_plateau=40, trapezoid_slope=80,
        ),
    }
    if cut:
        for stage, epochs in PIPELINE_EPOCHS.items():
            stage_block(config, stage)["max_epoch"] = epochs
    return config


def stage_block(config: dict, stage: str) -> dict:
    """A pipeline stage's block of the configuration."""
    suffix = "optimization_configuration" if stage == "aim_point" else "reconstruction_optimization_configuration"
    return config[f"{stage}_{suffix}"]


def run_pipeline_stage(device: torch.device, scenario, config: dict, stage: str, data: CalibrationData,
                       label: str) -> dict:
    """``generate_results.run_pipeline`` of one ``stage`` on ``scenario`` (its calibration
    parser over ``data``), timed, its launches asserted against the epochs it ran and its
    files against the JAX pipeline's names and keys. The result holds the stage's
    outputs under ``result``."""
    block = stage_block(config, stage)
    results_dir = pathlib.Path(config["results_dir"])

    def expected(recorder, output):
        if stage == "aim_point":
            return aim_point_loop_launches(len(recorder.epochs))
        history = output[1][0].loss_history
        stopped = len(history["total_loss"] if stage == "surface" else history) == len(recorder.epochs) - 1
        if stage == "kinematics":
            return kinematics_launches(ALIGNMENT, recorder.epochs, block["max_epoch"], block["log_step"], stopped)
        return surface_loop_launches(recorder.epochs, block["max_epoch"], block["log_step"], stopped,
                                     block["number_of_rays"] // PIPELINE_SURFACE_RAY_CHUNK)

    run = run_entry_point(
        device, label,
        lambda recorder: generate_results.run_pipeline(
            scenario, config, results_dir, which=stage, data_parser=CalibrationSamples(data),
            heliostat_data_mapping=[], device=device,
            stage_options={"surface": {"ray_chunk": PIPELINE_SURFACE_RAY_CHUNK}}, on_epoch=recorder,
        )[stage],
        expected,
    )
    for name, keys in PIPELINE_FILES[stage].items():
        path = results_dir / name
        if name.endswith(".npz"):
            with np.load(path) as archive:
                found = set(archive.files)
        else:
            found = set(json.loads(path.read_text()))
        if found != keys:
            raise AssertionError(f"{label}: {name} holds {sorted(found)}, expected {sorted(keys)}")
    run["epochs_per_second"] = run["epochs"] / run["seconds"]
    return run


class RuntimeLines(logging.Handler):
    """The records of ``track_runtime`` (the ``artist_tpu_torch.runtime`` logger)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())


def kinematics_stage(device: torch.device, config: dict, data: CalibrationData, known: np.ndarray,
                     label: str) -> tuple[dict, object]:
    """The pipeline's kinematics stage on a fresh copy of phase 13's field (deviations 0):
    the run, with its loss falling, its deviations' distance to ``known`` shrinking, its
    final loss, early-stopping epoch and largest deviation error; and the scenario."""
    scenario = kinematics_scenario(device, KINEMATICS)
    run = run_pipeline_stage(device, scenario, config, "kinematics", data, label)
    history = run["result"][1][0].loss_history
    deviations = scenario.heliostat_groups[0].rotation_deviations.cpu().numpy()
    before, after = float(np.linalg.norm(known)), float(np.linalg.norm(deviations - known))
    if not after < before:
        raise AssertionError(f"{label}: |deviations - known| {before} -> {after}")
    run.update(loss_ends=falling(label, history), final_loss=history[-1], distance_to_known=[before, after],
               largest_deviation_error=float(np.abs(deviations - known).max()), deviations=deviations)
    return run, scenario


def drive_pipeline(device: torch.device, data: CalibrationData, known: np.ndarray) -> dict[str, dict]:
    """Phase 17b: ``generate_results``'s three stages in sequence on one scenario in
    memory, phase 13's synthetic field (100 heliostats, 7 x 7 control points and 50 x 50
    points a facet, deviations 0), with :func:`pipeline_config` (no YAML): kinematics
    (alignment, 20 samples, 19 rays, max_epoch 500), surfaces (4 samples, 180 rays in ray
    chunks of 12) and aim points (30 rays, K = 16), on phase 13's calibration samples
    ``data``, cast with the rotation deviations ``known``. The deviations must near
    ``known``, the surface stage start from them, the surfaces' flux loss and the aim
    points' loss fall; every stage's launches and files are checked."""
    runtime_lines = RuntimeLines()
    runtime_log.addHandler(runtime_lines)
    runtime_log.setLevel(logging.INFO)
    runs: dict[str, dict] = {}
    try:
        with tempfile.TemporaryDirectory() as name:
            config = pipeline_config(pathlib.Path(name))
            runs["kinematics"], scenario = kinematics_stage(device, config, data, known, "phase 17b kinematics stage")
            with np.load(pathlib.Path(config["results_dir"]) / "kinematics_reconstruction.npz") as archive:
                saved = archive["group_0_rotation_deviations"]
            start = scenario.heliostat_groups[0].rotation_deviations.cpu().numpy()
            if not np.array_equal(start, saved):
                raise AssertionError("phase 17b: the surface stage does not start from the kinematics stage's result")
            runs["surface"] = run_pipeline_stage(device, scenario, config, "surface", data, "phase 17b surface stage")
            history = runs["surface"]["result"][1][0].loss_history
            runs["surface"].update(flux_loss_ends=falling("phase 17b surface stage (flux loss)", history["flux_loss"]),
                                   total_loss_ends=[history["total_loss"][0], history["total_loss"][-1]])
            runs["aim_point"] = run_pipeline_stage(device, scenario, config, "aim_point", data,
                                                   "phase 17b aim-point stage")
            runs["aim_point"].update(
                loss_ends=falling("phase 17b aim-point stage", runs["aim_point"]["result"][1]["total_loss"]),
                mean_intercept=float(runs["aim_point"]["result"][2].mean()),
            )
    finally:
        runtime_log.removeHandler(runtime_lines)
    for run in runs.values():
        run.pop("result")
        run.pop("deviations", None)
    report_runs("phase 17b", runs)
    _log(f"phase 17b track_runtime: {runtime_lines.lines}")
    return runs


def drive_alignment_spread(device: torch.device, data: CalibrationData, known: np.ndarray) -> dict:
    """Phase 17c: phase 17b's kinematics stage twice more in the production mode (the
    card's atomics in their own order) and once under deterministic algorithms, each on
    a fresh field for the configuration's max_epoch 500 (its early stopping ends it).
    Every run must reach the known deviations as phase 13 requires (the loss falls, the
    distance to them shrinks); the spread between the production runs is printed, not
    gated."""
    runs = {}
    with tempfile.TemporaryDirectory() as name:
        config = pipeline_config(pathlib.Path(name))
        for label in SPREAD_RUNS:
            context = deterministic_algorithms() if label == "deterministic" else contextlib.nullcontext()
            with context:
                runs[label] = kinematics_stage(device, config, data, known, f"phase 17c {label}")[0]
            runs[label].pop("result")
    first, second = (runs[label] for label in SPREAD_RUNS[:2])
    spread = dict(
        final_loss_relative=abs(first["final_loss"] - second["final_loss"]) / abs(first["final_loss"]),
        deviations_largest=float(np.abs(first["deviations"] - second["deviations"]).max()),
        stop_epochs=[first["last_epoch"], second["last_epoch"]],
        deterministic_over_production_epoch_seconds=runs["deterministic"]["epoch_seconds_median"]
        / np.mean([first["epoch_seconds_median"], second["epoch_seconds_median"]]),
    )
    for run in runs.values():
        run.pop("deviations")
    report_runs("phase 17c", runs)
    _log(f"phase 17c production-mode spread: {json.dumps(spread)}")
    return dict(runs=runs, spread=spread)


def drive_tools(device: torch.device, plant: dict) -> dict[str, dict]:
    """Phase 17d: ``memory_report`` at the plant configuration (phase 14a's field, its
    blocking on) chunked at 500 heliostats and unchunked, beside phase 14a's peaks; and
    ``ablate_step`` at ``bench.py``'s defaults without and with ``--block-window 96``, its
    launches asserted."""
    runs: dict[str, dict] = {}
    for chunk in (MEMORY_REPORT_CHUNK, 0):
        reset_launch_counts()
        report = memory_report.memory_report(device, heliostat_chunk=chunk, **MEMORY_REPORT)
        if not np.isfinite(report["loss"]):
            raise AssertionError(f"phase 17d memory_report, chunk {chunk}: loss {report['loss']}")
        runs[f"memory_report_chunk_{chunk or 'off'}"] = dict(report, launches=launch_counts())
    _log(
        f"phase 17d memory_report (4,000 heliostats x 2 rays x 50 x 50 x 4 points, blocking K = 16): "
        f"{json.dumps({k: {n: v for n, v in r.items() if n != 'launches'} for k, r in runs.items()})}; phase 14a's "
        f"aim-point peaks {plant['max_memory_allocated']} B chunked, {plant['unchunked_max_memory_allocated']} B "
        f"unchunked"
    )
    for window in (None, BLOCK_WINDOW["splat_block_window"]):
        reset_launch_counts()
        times = ablate_step.ablate(device, block_window=window, steps=ABLATE_STEPS)
        counts = launch_counts()
        step = LAUNCHES_PER_BLOCK_WINDOW_STEP if window else LAUNCHES_PER_STEP
        forward = "splat_dynamic_window_forward" if window else "splat_forward"
        expected = {name: (1 + ABLATE_STEPS) * (count + (CHUNKS if name == forward else 0))
                    for name, count in step.items()}
        if device.type == "cuda" and counts != expected:
            raise AssertionError(f"phase 17d ablate_step (window {window}) launched {counts}, expected {expected}")
        if not all(np.isfinite(times[k]) and times[k] > 0 for k in ("full", "forward", "geometry")):
            raise AssertionError(f"phase 17d ablate_step (window {window}): times {times}")
        runs[f"ablate_step{'_block_window' if window else ''}"] = dict(times, launches=counts)
        _log(f"phase 17d ablate_step, block window {window}: {json.dumps(times)} ms a call ({ABLATE_STEPS} calls)")
    return runs


# --------------------------------------------------------------------------- #
# Phase 18: the PAINT plot example (artist_tpu_torch/examples/paint_plots).
# --------------------------------------------------------------------------- #

# 18a: the field that maximum_number_of_heliostats_for_reconstruction (2,200) admits,
# cut to 2,000 PAINT heliostats, 3 calibration samples each (2 train, 1 test), the
# scenario at 5 x 5 points a facet with 10 rays a point: a train epoch traces
# [4000, 1000] rays onto 4,000 maps of 256 x 256. The heliostats stand in 40 rows 5 m
# apart of 50 columns 4 m apart (98 m east and west, 25-220 m north of the receiver), the
# extent of the PAINT field: on the synthetic grid's spacing (rows 12 m, columns 8 m)
# the last rows stand 553 m out.
PAINT_FIELD = dict(heliostats=2000, row_spacing=5.0, columns=50, column_spacing=4.0, samples=3, bitmap=(256, 256))
# reconstruction_generate_results' max_epoch; PERF.md §4 names any cut.
PAINT_EPOCHS = 1000
# The known rotation deviations, smaller than phase 13's: the rows reach 550 m from the
# receiver, where 4-8 mrad would throw a spot off its 8 x 7 m.
PAINT_KNOWN_DEVIATIONS = (1e-3, 2e-3)
# The HeliOS centroids: the UTIS ones (the traced centres of mass) moved by a normal
# offset of this deviation (m) along each axis of the receiver plane.
HELIOS_NOISE = 0.05
# A sun under which a heliostat cannot aim (its actuators' range) casts no flux on the
# receiver, and PAINT holds no such measurement: such a sample's sun is drawn again, at
# most this many times in all.
PAINT_SUN_DRAWS = 6
# 18b: the flux prediction's heliostats, phase 15's fits, east and north of the tower (m).
PREDICTION_PLACES = ((-8.0, 40.0), (8.0, 40.0), (0.0, 56.0))
PREDICTION_SURFACE_POINTS = (50, 50)  # load_scenario_from_hdf5's default, as the JAX script loads


def paint_names(count: int) -> list[str]:
    """PAINT-style heliostat names, two letters and two digits: AA00, AA01, ..."""
    return [f"{chr(65 + i // 2600)}{chr(65 + i // 100 % 26)}{i % 100:02d}" for i in range(count)]


def write_paint_grid(directory: pathlib.Path, size: dict) -> list[tuple[str, pathlib.Path]]:
    """The tower and ``size["heliostats"]`` PAINT heliostats on :func:`row_positions`' grid
    of ``size``'s spacing in ``directory``; their ``(name, properties file)``."""
    write_paint_tower(directory / "tower-measurements.json")
    files = []
    positions = row_positions(size["heliostats"], size["row_spacing"], size["columns"], size["column_spacing"])
    for i, (name, position) in enumerate(zip(paint_names(size["heliostats"]), positions)):
        files.append((name, write_paint_heliostat(directory / f"{name}-heliostat-properties.json",
                                                  float(position[0]), float(position[1]), SEED + 100 + i)))
    return files


def paint_calibration(scenario, deviations: np.ndarray, samples: int, bitmap: tuple[int, int],
                      draws: int = PAINT_SUN_DRAWS) -> tuple[CalibrationData, int]:
    """:func:`kinematics_calibration`, each sample that casts no flux cast again under a
    sun of the next draw, at most ``draws`` draws in all. Returns the samples and how
    many still cast none."""
    data = kinematics_calibration(scenario, deviations, samples, bitmap)
    for draw in range(1, draws):
        empty = data.flux_measured.reshape(len(data.flux_measured), -1).sum(axis=1) == 0
        if not empty.any():
            break
        again = kinematics_calibration(scenario, deviations, samples, bitmap, seed=SEED + 12 + 100 * draw)
        take = empty & (again.flux_measured.reshape(len(empty), -1).sum(axis=1) > 0)
        for field in ("flux_measured", "focal_spots", "incident_ray_directions", "motor_positions"):
            getattr(data, field)[take] = getattr(again, field)[take]
    return data, int((data.flux_measured.reshape(len(data.flux_measured), -1).sum(axis=1) == 0).sum())


def helios_centroids(data: CalibrationData, seed: int = SEED + 18) -> CalibrationData:
    """``data`` with its focal spots moved on the receiver plane (east and up) by a normal
    offset of :data:`HELIOS_NOISE` m along each axis."""
    offset = np.random.RandomState(seed).normal(0.0, HELIOS_NOISE, (len(data.focal_spots), 2))
    spots = np.array(data.focal_spots, dtype=np.float32, copy=True)
    spots[:, 0] += offset[:, 0]
    spots[:, 2] += offset[:, 1]
    return dataclasses.replace(data, focal_spots=spots)


class LossRecorder(EpochRecorder):
    """An ``on_epoch`` callback that also keeps each epoch's loss."""

    def __init__(self):
        super().__init__()
        self.losses: list[float] = []

    def __call__(self, epoch: int, loss: float) -> None:
        super().__call__(epoch, loss)
        self.losses.append(loss)


def paint_field(device: torch.device, size: dict = PAINT_FIELD):
    """Phase 18a's inputs: the PAINT field of ``size`` (JSON written here, loaded by
    ``reconstruction_scenario.reconstruction_scenario``), its known rotation deviations
    and UTIS calibration data (:func:`paint_calibration`). Returns (scenario, known,
    data, samples without flux, seconds for the scenario, seconds for the data)."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as name:
        directory = pathlib.Path(name)
        files = write_paint_grid(directory, size)
        scenario = reconstruction_scenario.reconstruction_scenario(directory / "tower-measurements.json", files,
                                                                   device=device)
    synchronize(device)
    scenario_seconds = time.perf_counter() - start
    known = known_rotation_deviations(scenario.heliostat_groups[0].number_of_heliostats,
                                      magnitudes=PAINT_KNOWN_DEVIATIONS)
    start = time.perf_counter()
    utis, empty = paint_calibration(scenario, known, size["samples"], size["bitmap"])
    return scenario, known, utis, empty, scenario_seconds, time.perf_counter() - start


def drive_paint_reconstruction(device: torch.device, size: dict = PAINT_FIELD, max_epoch: int = PAINT_EPOCHS):
    """Phase 18a: ``reconstruction_generate_results.generate_reconstruction_results`` on
    the PAINT field of ``size``, its scenario parsed from PAINT JSON written here and
    loaded from its image by ``reconstruction_scenario.reconstruction_scenario``, on
    calibration samples cast with known rotation deviations (:func:`kinematics_calibration`):
    UTIS centroids at the traced centres of mass, HeliOS ones moved off them
    (:func:`helios_centroids`). Both runs' losses must fall from epoch 0, the UTIS run
    end below the HeliOS one on the held-out samples, every heliostat have finite
    losses and its position, and the launches be the loop's. Returns the path's numbers, the scenario and the UTIS
    parser."""
    phase = "phase 18a"
    scenario, known, utis, empty, scenario_seconds, calibration_seconds = paint_field(device, size)
    group = scenario.heliostat_groups[0]
    data = {"UTIS": utis, "HeliOS": helios_centroids(utis)}
    recorders = {centroid: LossRecorder() for centroid in data}
    starts: dict[str, float] = {}

    def parser(centroid: str) -> CalibrationDataParser:
        starts[centroid] = time.perf_counter()
        return CalibrationDataParser(data[centroid], group.names, reconstruction_generate_results.SAMPLE_LIMIT)

    details: dict[str, dict] = {}
    synchronize(device)
    reset_peak_memory(device)
    reset_launch_counts()
    start = time.perf_counter()
    results, syncs = counted_syncs(
        lambda: reconstruction_generate_results.generate_reconstruction_results(
            scenario, max_epoch=max_epoch, device=device, data_parser=parser, on_epoch=recorders, details=details
        ),
        device,
    )
    synchronize(device)
    seconds = time.perf_counter() - start
    counts = launch_counts()
    peak = max_memory(device)

    block = reconstruction_generate_results.optimization_configuration(max_epoch)[constants.optimization]
    expected = launches()
    runs = {}
    for centroid, recorder in recorders.items():
        stopped = len(recorder.epochs) < max_epoch + 1
        run_launches = kinematics_launches(RAYTRACING, recorder.epochs, max_epoch, block[constants.log_step], stopped)
        expected = {name: expected[name] + run_launches[name] for name in KERNELS}
        runs[centroid] = dict(
            seconds=recorder.ends[-1] - starts[centroid],
            epochs=len(recorder.epochs),
            stopped=stopped,
            epoch_seconds_median=float(np.median(np.diff(recorder.ends))) if len(recorder.ends) > 1 else None,
            loss_ends=falling(f"{phase} {centroid}", recorder.losses),
            final_losses_mean=float(np.mean([entry[centroid] for entry in results.values()])),
            test_focal_spot_loss_mean=float(np.mean(np.concatenate(
                [r.test_loss["focal_spot_loss"] for r in details[centroid]["results"]]
            ))),
            distance_to_known=[float(np.linalg.norm(known)),
                               float(np.linalg.norm(details[centroid]["rotation_deviations"][0] - known))],
            launches=run_launches,
        )
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"{phase} launched {counts}, expected {expected}")
    # Two train samples a heliostat against its four rotation deviations: each run can
    # fit its own centroids, noise and all, and more than one set of deviations casts the
    # same two spots. So the held-out sample tells the methods apart; the distance to
    # the known deviations is printed, not gated.
    held_out = {centroid: run["test_focal_spot_loss_mean"] for centroid, run in runs.items()}
    if not held_out["UTIS"] < held_out["HeliOS"]:
        raise AssertionError(f"{phase}: the test focal-spot losses {held_out} (m)")
    if set(results) != set(group.names) or not all(
        np.isfinite(entry["UTIS"]) and np.isfinite(entry["HeliOS"]) and len(entry["Position"]) == 4
        for entry in results.values()
    ):
        raise AssertionError(f"{phase}: the results do not carry every heliostat with finite losses and a position")
    epochs = sum(run["epochs"] for run in runs.values())
    result = dict(
        launches=counts,
        heliostats=group.number_of_heliostats,
        samples=len(utis.flux_measured),
        samples_without_flux=empty,
        scenario_seconds=scenario_seconds,
        calibration_seconds=calibration_seconds,
        seconds=seconds,
        max_epoch=max_epoch,
        max_memory_allocated=peak,
        host_syncs=syncs,
        host_syncs_per_epoch=None if syncs is None else syncs / epochs,
        runs=runs,
    )
    _log(
        f"{phase} PAINT reconstruction ({group.number_of_heliostats} heliostats x {size['samples']} samples, "
        f"{scenario.light_sources[0].number_of_rays} rays a point at 5 x 5 points a facet, max_epoch {max_epoch}): "
        f"scenario {scenario_seconds:.3f} s, samples {calibration_seconds:.3f} s ({empty} without flux); both runs "
        f"{seconds:.6f} s, max_memory_allocated {peak} B, {syncs} host syncs "
        f"({result['host_syncs_per_epoch']} an epoch), launches { {k: v for k, v in counts.items() if v} }; "
        + "; ".join(
            f"{centroid}: {run['epochs']} epochs in {run['seconds']:.6f} s, {run['epoch_seconds_median']} s an epoch "
            f"(median after the first), mean pointing error {run['loss_ends'][0]:.6g} -> {run['loss_ends'][1]:.6g} m, "
            f"final per-heliostat mean {run['final_losses_mean']:.6g} m, test focal-spot loss "
            f"{run['test_focal_spot_loss_mean']:.6g} m, |deviations - known| {run['distance_to_known'][0]:.6g} -> "
            f"{run['distance_to_known'][1]:.6g}"
            for centroid, run in runs.items()
        )
    )
    return result, scenario, CalibrationDataParser(utis, group.names, reconstruction_generate_results.SAMPLE_LIMIT)


def check_paint_kernels(scenario, parser: CalibrationDataParser) -> dict[str, dict]:
    """Phase 18a's kernel check: the splat pair at the reconstruction's train batch
    (``[4000, 1000]`` rays onto ``[4000, 256, 256]``) and row 1 at its validation batch,
    against the plain versions, timed. Returns the timings under "paint_reconstruction"
    and "paint_reconstruction_validation"."""
    return check_reconstructor_batches(
        paint_reconstructor(scenario, parser), "phase 18a", "paint_reconstruction", "paint_reconstruction_validation",
        SEED + 19,
    )


def paint_reconstructor(scenario, parser: CalibrationDataParser) -> KinematicsReconstructor:
    """The reconstruction example's kinematics reconstructor on ``scenario`` and ``parser``, without epochs."""
    return KinematicsReconstructor(
        scenario=scenario,
        data={constants.data_parser: parser, constants.heliostat_data_mapping: []},
        optimization_configuration=reconstruction_generate_results.optimization_configuration(0),
        reconstruction_method=RAYTRACING,
        focal_spot_ground_truth="focal_spots",
    )


def prediction_calibration(tower: SolarTower, names, seed: int = SEED + 31) -> CalibrationData:
    """One calibration measurement a heliostat of ``names``: a sun south of the field, a
    focal spot within a few decimetres of the receiver's centre, and a measured image (a
    Gaussian spot in [0, 1] at 256 x 256)."""
    rng = np.random.RandomState(seed)
    count = len(names)
    targets = torch.zeros(count, dtype=torch.long, device=tower.planar_centers.device)
    spots = get_centers_of_target_areas(tower, targets).cpu().numpy().copy()
    spots[:, [0, 2]] += rng.normal(0.0, 0.3, (count, 2))
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    images = np.stack([np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / 0.01) for c in rng.uniform(0.4, 0.6, (count, 2))])
    return CalibrationData(
        flux_measured=images.astype(np.float32),
        focal_spots=spots.astype(np.float32),
        incident_ray_directions=sun_directions(count, seed),
        motor_positions=np.zeros((count, 2), np.float32),
        active_heliostats_mask=np.ones(count, np.int32),
        target_area_indices=np.zeros(count, np.int32),
    )


def drive_paint_flux_prediction(device: torch.device, surfaces: list) -> dict[str, dict]:
    """Phase 18b: ``flux_prediction_raytracing.generate_flux_images`` on both scenarios of
    ``flux_prediction_scenario`` for phase 15's three heliostats (PAINT JSON written here):
    ideal surfaces of 20 x 20 control points and phase 15's fits ``surfaces``, loaded at
    50 x 50 points a facet; each heliostat aimed at a measured focal spot and traced with
    1,000 rays a point onto 256 x 256 (30 M rays a scenario). The six bitmaps must be
    finite with flux, the ideal and fitted ones differ by more than a second ideal run
    differs from the first, and the results carry the JAX keys."""
    phase = "phase 18b"
    names = list(INGRESS_HELIOSTATS)
    scenarios = {}
    with tempfile.TemporaryDirectory() as name:
        directory = pathlib.Path(name)
        write_paint_tower(directory / "tower-measurements.json")
        for i, (heliostat, (east, north)) in enumerate(zip(names, PREDICTION_PLACES)):
            (directory / heliostat / "Properties").mkdir(parents=True)
            write_paint_heliostat(flux_prediction_scenario.properties_path(directory, heliostat), east, north,
                                  SEED + 30 + i)
        for stem, use in flux_prediction_scenario.SCENARIOS.items():
            generator = flux_prediction_scenario.flux_prediction_scenario_generator(
                directory / flux_prediction_scenario.scenario_file(stem), directory / "tower-measurements.json",
                directory, names, use, fitted_surfaces=dict(zip(names, surfaces)) if use else None, device=device,
            )
            scenarios[stem] = load_scenario_from_image(generator.scenario_image(), PREDICTION_SURFACE_POINTS,
                                                       device=device)
    group = scenarios["ideal"].heliostat_groups[0]
    parser = CalibrationDataParser(prediction_calibration(scenarios["ideal"].solar_tower, group.names), group.names)
    measurements = {heliostat: i for i, heliostat in enumerate(group.names)}
    results: dict[str, np.ndarray] = {}
    runs = {}
    for stem, scenario in scenarios.items():
        run = run_entry_point(
            device, f"{phase} {stem}",
            lambda recorder, stem=stem, scenario=scenario: flux_prediction_raytracing.generate_flux_images(
                scenario, measurements, None, results, stem, data_parser=parser, device=device
            ),
            lambda recorder, result: launches(splat_forward=len(scenario.heliostat_groups)),
        )
        run.pop("result")
        run["rays"] = len(names) * flux_prediction_raytracing.NUMBER_OF_RAYS * group.surface_points.shape[1]
        runs[stem] = run
    again = flux_prediction_raytracing.generate_flux_images(
        scenarios["ideal"], measurements, None, {}, "ideal", data_parser=parser, device=device
    )
    keys = {f"{heliostat}/{key}" for heliostat in names for key in ("ideal", "fitted", "utis")}
    if set(results) != keys:
        raise AssertionError(f"{phase}: results keyed {sorted(results)}, expected {sorted(keys)}")
    for key, image in results.items():
        if image.shape != (256, 256) or not np.isfinite(image).all() or not image.sum() > 0:
            raise AssertionError(f"{phase}: {key} is not a finite 256 x 256 bitmap with flux")
    spread = max(float(np.abs(again[f"{h}/ideal"] - results[f"{h}/ideal"]).max()) for h in names)
    gaps = {h: float(np.abs(results[f"{h}/fitted"] - results[f"{h}/ideal"]).max()) for h in names}
    if not min(gaps.values()) > spread:
        raise AssertionError(f"{phase}: ideal against fitted {gaps}, not above the run-to-run spread {spread}")
    runs["ideal"].update(run_to_run_spread=spread, fitted_gaps=gaps,
                         peaks={h: float(results[f"{h}/ideal"].max()) for h in names})
    report_runs(phase, runs)
    return runs


def drive_paint_demo(device: torch.device) -> dict:
    """Phase 18c: ``flux_prediction_plot.demo_prediction`` of one heliostat (7 x 7 control
    points, 120 rays, 50 x 50 points a facet) on 3 calibration samples cast on the card,
    aligned with their motor positions, traced and cropped around the centre of mass,
    on the card and on the CPU with the same distortions: within TUTORIAL_FLUX_SHARE of
    the flux peak."""
    phase = "phase 18c"
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as name:
        directory = pathlib.Path(name)
        write_paint_tower(directory / "tower-measurements.json")
        write_paint_heliostat(directory / "AA39-heliostat-properties.json", *TUTORIAL_PLACES[0], SEED + 40)
        scenario = flux_prediction_plot.demo_scenario(directory, "AA39", device)
        on_cpu = flux_prediction_plot.demo_scenario(directory, "AA39", cpu)
    parser = CalibrationDataParser(
        kinematics_calibration(scenario, np.zeros((1, 4), np.float32), TUTORIAL_SAMPLES, (256, 256)), ("AA39",)
    )
    points = scenario.heliostat_groups[0].surface_points.shape[1]
    distortions = Sun(number_of_rays=flux_prediction_plot.DEMO_RAYS).get_distortions(
        torch.Generator(device="cpu").manual_seed(SEED + 41), points, TUTORIAL_SAMPLES
    )
    sun = FixedDistortions(flux_prediction_plot.DEMO_RAYS, *(d.numpy() for d in distortions))
    run = run_entry_point(
        device, phase,
        lambda recorder: flux_prediction_plot.demo_prediction(scenario, data_parser=parser, sun=sun, device=device),
        lambda recorder, result: launches(splat_forward=1),
    )
    reference = flux_prediction_plot.demo_prediction(on_cpu, data_parser=parser, sun=sun, device=cpu)["predicted"]
    predicted = run.pop("result")["predicted"].cpu()
    gap = float((predicted - reference).abs().max() / reference.max())
    if not (torch.isfinite(predicted).all() and float(reference.max()) > 0 and gap <= TUTORIAL_FLUX_SHARE):
        raise AssertionError(f"{phase}: card against CPU {gap} of the flux peak")
    run.update(flux_gap_to_cpu=gap, samples=int(predicted.shape[0]))
    report_runs(phase, {"demo": run})
    return run


def drive_paint_plots(device: torch.device, surfaces: list) -> tuple[dict[str, dict], dict[str, dict]]:
    """Phase 18: 18a, its kernels, 18b and 18c. Returns the paths' numbers and the
    kernels' timings at 18a's shape."""
    paths: dict[str, dict] = {}
    paths["paint_reconstruction"], scenario, parser = drive_paint_reconstruction(device)
    empty_cache(device)
    timings = check_paint_kernels(scenario, parser)
    del scenario, parser
    empty_cache(device)
    for stem, run in drive_paint_flux_prediction(device, surfaces).items():
        paths[f"paint_flux_prediction_{stem}"] = run
    empty_cache(device)
    paths["paint_demo"] = drive_paint_demo(device)
    return paths, timings


# Phase 19: the ray kernel pair (kernels/rays.py, csrc/rays.cu) against its plain versions.
RAY_SHAPES = {
    "surface_reconstruction_chunk": (36, 12, 10000),
    "kinematics_validation": (500, 19, 10000),
    "kinematics_train": (1500, 19, 10000),
}
RAY_BITMAP = (256, 256)
RAY_EXTINCTION = 0.1
RAY_BYTES_PER_RAY = 20  # both kernels: 8 B of angles, and 12 B of e, u, w written or of cotangents read
RAY_BYTES_PER_POINT = {"ray_forward": 32, "ray_backward": 64}
# The plain versions run over this many heliostats at once on the card.
RAY_PLAIN_HELIOSTATS = 100
# Kernel against plain on the card: the forward rounds as PyTorch's kernels do, but for the
# sines and cosines (sincosf against sin and cos) and the splat coordinates' last bits; the
# backward contracts products into FMAs and sums the rays in another order.
RAY_COORDINATE_TOLERANCE = 2.0**-10  # pixels, 64 ulp at 255
RAY_INTENSITY_TOLERANCE = 8 * UNIT_ROUNDOFF  # of the largest intensity
RAY_GRADIENT_TOLERANCE = 64 * UNIT_ROUNDOFF  # of the gradient's largest entry


def ray_launches(forward: int, backward: int) -> dict[str, int]:
    return {"ray_forward": forward, "ray_backward": backward}


def ray_tower(device: torch.device, dtype: torch.dtype = torch.float32) -> SolarTower:
    """Two planar target areas facing the field (+n): the synthetic field's 10 x 10 m
    receiver at 45 m and a 4 x 3 m one at 30 m, 8 m east of it."""

    def tensor(x) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype, device=device)

    return SolarTower(
        planar_centers=tensor([[0.0, -3.0, 45.0, 1.0], [8.0, -3.0, 30.0, 1.0]]),
        planar_normals=tensor([[0.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]]),
        planar_dimensions=tensor([[10.0, 10.0], [4.0, 3.0]]),
        cylindrical_centers=torch.zeros((0, 4), dtype=dtype, device=device),
        cylindrical_axes=torch.zeros((0, 4), dtype=dtype, device=device),
        cylindrical_normals=torch.zeros((0, 4), dtype=dtype, device=device),
        cylindrical_radii=torch.zeros((0,), dtype=dtype, device=device),
        cylindrical_heights=torch.zeros((0,), dtype=dtype, device=device),
        cylindrical_opening_angles=torch.zeros((0,), dtype=dtype, device=device),
        planar_names=("receiver", "second"),
    )


def ray_edge_cases(dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Origins and preferred directions ``[K, 4]`` of rays onto :func:`ray_tower`'s receiver,
    traced with zero angles, each from 10 m in front of it straight at it unless said: on
    each edge of the bitmap (e at 0 and at res_e - 1, u at 0 and at res_u - 1, exactly)
    and one float step past it; a back-facing ray; a grazing one (d . n = 0); one from
    behind the receiver (front-facing, at a negative distance); one at the centre."""
    step = lambda x, toward: float(np.nextafter(np.float32(x), np.float32(toward)))  # noqa: E731
    middle = 45.0
    # The hit's e is 5 + the origin's e: a step of the origin past 5 must be one of 10.
    past_right = float(np.float32(5.0) + np.spacing(np.float32(10.0)))
    cases = [
        ((-5.0, 7.0, middle), (0.0, -1.0, 0.0)),  # bitmap e (before the flip) at 0
        ((step(-5.0, -10.0), 7.0, middle), (0.0, -1.0, 0.0)),
        ((5.0, 7.0, middle), (0.0, -1.0, 0.0)),  # at res_e - 1
        ((past_right, 7.0, middle), (0.0, -1.0, 0.0)),
        ((0.0, 7.0, 40.0), (0.0, -1.0, 0.0)),  # u at 0
        ((0.0, 7.0, step(40.0, 0.0)), (0.0, -1.0, 0.0)),
        ((0.0, 7.0, 50.0), (0.0, -1.0, 0.0)),  # at res_u - 1
        ((0.0, 7.0, step(50.0, 100.0)), (0.0, -1.0, 0.0)),
        ((5.0, 7.0, 50.0), (0.0, -1.0, 0.0)),  # the corner
        ((0.0, 7.0, middle), (0.0, 1.0, 0.0)),  # back-facing
        ((0.0, 7.0, middle), (1.0, 0.0, 0.0)),  # grazing
        ((0.0, -10.0, middle), (0.0, -1.0, 0.0)),  # from behind the receiver
        ((0.0, 7.0, middle), (0.0, -1.0, 0.0)),  # the centre
    ]
    origins = torch.tensor([[*o, 1.0] for o, _ in cases], dtype=dtype)
    directions = torch.tensor([[*d, 0.0] for _, d in cases], dtype=dtype)
    return origins, directions


def ray_chunk_inputs(heliostats: int, rays: int, points: int, device: torch.device, seed: int,
                     dtype: torch.dtype = torch.float32) -> dict:
    """A chunk's inputs for the ray pair: heliostats 25-60 m north of :func:`ray_tower`,
    the odd ones aimed at its second target; each point aimed within +-7 m (+-3 m on the
    second) of its target's centre, so that many rays miss it on every side; angles
    drawn as ``Sun.get_distortions`` draws them, 10 mrad wide, as views of one
    ``[M, R, P, 2]`` sample. Heliostat 0's first points are :func:`ray_edge_cases`
    with zero angles. Also per-heliostat magnitudes ``[M, 1, 1]``."""
    generator = torch.Generator(device=device).manual_seed(seed)

    def uniform(low: float, high: float, *shape) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=generator, device=device, dtype=dtype)

    tower = ray_tower(device, dtype)
    targets = torch.arange(heliostats, device=device) % 2
    position = torch.stack([uniform(-15.0, 15.0, heliostats), uniform(25.0, 60.0, heliostats),
                            uniform(0.0, 3.0, heliostats)], dim=-1)
    origins = torch.ones((heliostats, points, 4), dtype=dtype, device=device)
    origins[..., :3] = position[:, None, :] + torch.stack(
        [uniform(-2.0, 2.0, heliostats, points), uniform(-0.2, 0.2, heliostats, points),
         uniform(-2.0, 2.0, heliostats, points)], dim=-1)
    reach = torch.tensor([7.0, 3.0], dtype=dtype, device=device)[targets][:, None]
    aim = tower.planar_centers[targets][:, None, :3].expand(heliostats, points, 3).clone()
    aim[..., 0] += reach * uniform(-1.0, 1.0, heliostats, points)
    aim[..., 2] += reach * uniform(-1.0, 1.0, heliostats, points)
    preferred = torch.zeros_like(origins)
    preferred[..., :3] = torch.nn.functional.normalize(aim - origins[..., :3], dim=-1)
    sample = 0.01 * torch.randn((heliostats, rays, points, 2), generator=generator, device=device, dtype=dtype)
    edge_origins, edge_directions = ray_edge_cases(dtype)
    edges = min(points, edge_origins.shape[0])
    origins[0, :edges] = edge_origins[:edges].to(device)
    preferred[0, :edges] = edge_directions[:edges].to(device)
    sample[0, :, :edges] = 0.0
    return dict(
        preferred=preferred, origins=origins, distortions_u=sample[..., 0], distortions_e=sample[..., 1],
        tower=tower, targets=targets, magnitudes=uniform(0.5, 2.0, heliostats, 1, 1),
    )


def ray_arguments(inputs: dict, magnitude) -> tuple:
    """The positional arguments of the pair's kernels and plain versions, but the cotangents."""
    return (inputs["preferred"], inputs["origins"], inputs["distortions_u"], inputs["distortions_e"],
            inputs["tower"], inputs["targets"], magnitude, RAY_BITMAP, RAY_EXTINCTION,
            DEFAULT_MIRROR_REFLECTIVITY)


def ray_slice(arguments: tuple, start: int, stop: int) -> tuple:
    """``arguments`` for heliostats ``[start, stop)``."""
    preferred, origins, du, de, tower, targets, magnitude, *rest = arguments
    if isinstance(magnitude, torch.Tensor) and magnitude.numel() > 1:
        magnitude = magnitude[start:stop]
    return (preferred[start:stop], origins[start:stop], du[start:stop], de[start:stop], tower,
            targets[start:stop], magnitude, *rest)


def check_ray_pair(label: str, arguments: tuple, cotangents: tuple) -> dict:
    """The pair at one shape against the plain versions (by RAY_PLAIN_HELIOSTATS
    heliostats), two launches each bit-equal, launches counted. Returns the errors."""
    before = dict(ray_kernels.LAUNCHES)
    forward = ray_kernels.rays_forward_cuda(*arguments)
    again = ray_kernels.rays_forward_cuda(*arguments)
    grads = ray_kernels.rays_backward_cuda(*arguments, *cotangents)
    grads_again = ray_kernels.rays_backward_cuda(*arguments, *cotangents)
    torch.cuda.synchronize()
    counted = {name: ray_kernels.LAUNCHES[name] - before[name] for name in before}
    if counted != ray_launches(2, 2):
        raise AssertionError(f"phase 19 {label}: launched {counted}, expected {ray_launches(2, 2)}")
    if not all(torch.equal(a, b) for a, b in zip(forward + grads, again + grads_again)):
        raise AssertionError(f"phase 19 {label}: two launches differ")
    num = arguments[0].shape[0]
    errors = dict(coordinates=0.0, intensities=0.0, preferred=0.0, origins=0.0, validity_flips=0, count_gap=0)
    scale = dict(intensities=float(forward[2].abs().max()), preferred=float(grads[0].abs().max()),
                 origins=float(grads[1].abs().max()))
    for start in range(0, num, RAY_PLAIN_HELIOSTATS):
        stop = min(num, start + RAY_PLAIN_HELIOSTATS)
        part = ray_slice(arguments, start, stop)
        e, u, w, counts = ray_kernels.rays_forward_plain(*part)
        kernel = [x[start:stop] for x in forward[:3]]
        invalid = [(x == RAY_BITMAP[0] - 1) & (y == 0) & (z == 0) for x, y, z in ((e, u, w), kernel)]
        flips = invalid[0] != invalid[1]
        errors["validity_flips"] += int(flips.sum())
        keep = ~flips
        errors["coordinates"] = max(errors["coordinates"], _max_abs_err(kernel[0][keep], e[keep]),
                                    _max_abs_err(kernel[1][keep], u[keep]))
        errors["intensities"] = max(errors["intensities"], _max_abs_err(kernel[2][keep], w[keep]))
        errors["count_gap"] = max(errors["count_gap"], int((forward[3][:, start:stop] - counts).abs().max()))
        plain_grads = ray_kernels.rays_backward_plain(*part, *(c[start:stop] for c in cotangents))
        errors["preferred"] = max(errors["preferred"], _max_abs_err(grads[0][start:stop], plain_grads[0]))
        errors["origins"] = max(errors["origins"], _max_abs_err(grads[1][start:stop], plain_grads[1]))
        del e, u, w, counts, kernel, invalid, plain_grads
    failures = []
    if errors["validity_flips"] or errors["count_gap"]:
        failures.append(f"{errors['validity_flips']} rays valid on one side only, counts apart by {errors['count_gap']}")
    if errors["coordinates"] > RAY_COORDINATE_TOLERANCE:
        failures.append(f"coordinates apart by {errors['coordinates']} px")
    for key, tolerance in (("intensities", RAY_INTENSITY_TOLERANCE), ("preferred", RAY_GRADIENT_TOLERANCE),
                           ("origins", RAY_GRADIENT_TOLERANCE)):
        if errors[key] > tolerance * scale[key]:
            failures.append(f"{key} apart by {errors[key]} (scale {scale[key]})")
    if failures:
        raise AssertionError(f"phase 19 {label}: " + "; ".join(failures))
    return errors


def ray_route_launches(device: torch.device) -> dict[str, dict[str, int]]:
    """The pair's launches in :func:`small_step` at SMALL (2 checkpointed ray chunks: 2
    forwards and 1 backward a chunk, then a render without a gradient, 1 forward a chunk)
    and unchunked (a forward and a backward, then a forward). Phase 13 counts them in the
    kinematics reconstructor's epochs and validations."""
    rng = np.random.RandomState(SEED + 19)
    points = 4 * SMALL["surface_points"][0] * SMALL["surface_points"][1]
    distortions = rng.normal(0.0, 1e-2, (2, SMALL["heliostats"], SMALL["rays"], points)).astype(np.float32)
    chunks = SMALL["rays"] // SMALL["ray_chunk"]
    expected = {
        "checkpointed": ray_launches(3 * chunks, chunks),
        "unchunked": ray_launches(2, 1),
    }
    found = {}
    for label, size in (("checkpointed", SMALL), ("unchunked", dict(SMALL, ray_chunk=None))):
        ray_kernels.reset_launch_counts()
        small_step(device, distortions, None, size)
        found[label] = dict(ray_kernels.LAUNCHES)
    if device.type == "cuda" and found != expected:
        raise AssertionError(f"phase 19: the routes launched {found}, expected {expected}")
    return found


def check_ray_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 19: the ray pair against its plain versions at RAY_SHAPES (on and past the
    bitmap's edges, a per-heliostat and a scalar magnitude), timed by events and from a
    CUDA graph against the bytes bound; then the routes' launches. Returns the timings."""
    timings = {name: {} for name in ("ray_forward", "ray_backward")}
    for index, (label, (num, rays, points)) in enumerate(RAY_SHAPES.items()):
        inputs = ray_chunk_inputs(num, rays, points, device, SEED + 19 + index)
        magnitude = inputs["magnitudes"] if index % 2 == 0 else 0.75
        arguments = ray_arguments(inputs, magnitude)
        generator = torch.Generator(device=device).manual_seed(SEED + 190 + index)
        cotangents = tuple(torch.randn((num, rays, points), generator=generator, device=device) for _ in range(3))
        errors = check_ray_pair(label, arguments, cotangents)
        total_rays = num * rays * points
        for name, fn in (
            ("ray_forward", lambda: ray_kernels.rays_forward_cuda(*arguments)),
            ("ray_backward", lambda: ray_kernels.rays_backward_cuda(*arguments, *cotangents)),
        ):
            bytes_moved = RAY_BYTES_PER_RAY * total_rays + RAY_BYTES_PER_POINT[name] * num * points
            timing = dict(
                replaces="none (the PyTorch chain apply_distortion_rotation -> line_plane_intersections)",
                ms=event_ms(fn, iterations=10), graph_ms=graph_ms(fn, iterations=10),
                bound=bound_ms(bytes_moved, 0.0), max_abs_err=errors, plain_ms=None, library_ms=None,
            )
            timings[name][label] = timing
            _log(
                f"phase 19 {name} at [{num}, {rays}, {points}] ({label}): {timing['ms']:.4f} ms by events, "
                f"{timing['graph_ms']:.4f} ms replayed from a CUDA graph, {describe_bound(timing)}, "
                f"{100 * timing['bound'][0] / timing['graph_ms']:.1f}% of it; against the plain version "
                f"{json.dumps(errors)}"
            )
        del inputs, arguments, cotangents
        empty_cache(device)
    found = ray_route_launches(device)
    _log(f"phase 19 launches: {json.dumps(found)}")
    return timings


# Phase 20: the compacted blocking route's ray kernels (kernels/blocked_rays.py,
# csrc/blocked_rays.cu) against their plain versions, on the aim1000.aim_point cell's first
# chunk and on a small grid field with edge rays.
BLOCKED_CELL = "aim1000.aim_point"
BLOCKED_SEED = 2_930_000_011
BLOCKED_CANDIDATES = 16
# Bytes a ray and a point of each kernel (the source's head note).
BLOCKED_BYTES = {
    "blocked_trace_forward": (40, 32),
    "corridor_statistics": (8, 32),
    "blocked_epilogue": (12, 0),
    "blocked_epilogue_backward": (20, 0),
    "blocked_trace_backward": (36, 64),
}
# The plain versions run over this many heliostats at once on the card.
BLOCKED_PLAIN_HELIOSTATS = 50
# Kernel against plain on the card: the ray forward rounds as PyTorch's kernels do but for the
# sines and cosines (sincosf against sin and cos); the statistics sum in another order (the
# mean direction and the centre, in double across blocks) and contract the cosine's products
# into FMAs; the backwards contract products and sum the rays in another order.
BLOCKED_DIRECTION_TOLERANCE = 8 * UNIT_ROUNDOFF  # a unit vector's components
BLOCKED_STATISTICS_TOLERANCE = 2.0**-16  # statistics_err: of the largest length, or absolute on unit vectors
BLOCKED_GRADIENT_TOLERANCE = 64 * UNIT_ROUNDOFF  # of the gradient's largest entry
# A small grid field: 3 columns 4.5 m apart, 7 rows 3.5 m apart from 100 m north.
BLOCKED_GRID = dict(heliostats=21, rays=3, points=40)


class _Captured(Exception):
    """Ends a call once the first traced chunk's inputs are kept."""


def captured_trace_inputs(entry) -> dict:
    """The keyword arguments of the first ``trace_rays`` call that ``entry``'s aim-point
    optimizer makes (the first chunk of its epoch-0 references), detached."""
    import artist_tpu_torch.optim.aim_point_optimizer as optimizer_module

    original, kept = optimizer_module.trace_rays, {}

    def detached(x):
        if isinstance(x, tuple):
            return tuple(detached(y) for y in x)
        return x.detach() if isinstance(x, torch.Tensor) else x

    def capture(**kwargs):
        kept.update({key: detached(value) for key, value in kwargs.items()})
        raise _Captured

    optimizer_module.trace_rays = capture
    try:
        entry.restore()
        entry.call(lambda epoch, loss: None)
    except _Captured:
        pass
    finally:
        optimizer_module.trace_rays = original
    if not kept:
        raise AssertionError("the entry traced nothing")
    return kept


def blocked_inputs_from_trace(kwargs: dict) -> dict:
    """The compacted route's kernel inputs from ``trace_rays``' keyword arguments."""
    config = kwargs["config"]
    preferred = geometry.reflect(kwargs["incident_ray_directions"][:, None, :], kwargs["aligned_surface_normals"])
    return dict(
        preferred=preferred.contiguous(), origins=kwargs["aligned_surface_points"].contiguous(),
        distortions_u=kwargs["distortions_u"], distortions_e=kwargs["distortions_e"], tower=kwargs["tower"],
        targets=kwargs["target_area_indices"], magnitudes=kwargs["ray_magnitude"],
        primitives=kwargs["blocking_primitives"], own=kwargs["ray_primitive_indices"],
        candidates=config.blocking_candidates, bitmap=tuple(config.bitmap_resolution),
        extinction=config.ray_extinction_factor, reflectivity=config.mirror_reflectivity,
    )


def aim1000_chunk_inputs(device: torch.device, seed: int = BLOCKED_SEED) -> dict:
    """The first chunk of the benchmark's aim1000.aim_point cell as its job builds it from
    ``seed`` on ``device``: ``[250, 30, 10000]`` rays, 1,000 primitives, K = 16."""
    from benchmark import run as benchmark_run
    from benchmark.field import field_arrays
    from benchmark.jobs import aim_point_optimization as job

    _, _, workload, config = benchmark_run.cell(REPO, BLOCKED_CELL)
    arrays = field_arrays(config["field"])
    data = job.make_traffic(arrays, workload["traffic_parameters"], seed, device)
    entry = job.build(config, workload, arrays, data, seed, device)
    return blocked_inputs_from_trace(captured_trace_inputs(entry))


def blocked_chunk_inputs(heliostats: int, rays: int, points: int, device: torch.device, seed: int,
                         dtype: torch.dtype = torch.float32, columns: int = 3, row_spacing: float = 3.5) -> dict:
    """A chunk's inputs for the compacted route on :func:`ray_tower`: heliostats on a grid of
    ``columns`` columns 4.5 m apart and rows ``row_spacing`` apart from 100 m north, heliostat
    0 in the back row; each a vertical 3.2 x 2.5 m panel facing north at 1.7 m (its points
    drawn on it, its primitive the panel), aimed as :func:`ray_chunk_inputs` aims, its angles
    10 mrad wide as views of one ``[M, R, P, 2]`` sample; the odd ones at the second target.
    Heliostat 0's first points are :func:`ray_edge_cases` with zero angles; heliostat 1's first
    ray a point scatters 30 times wider, so that its corridor holds every heliostat ahead of it
    and it keeps a candidate in every slot. Rays climb ~0.4 m a metre, so that a row blocks the
    lower part of the one behind it."""
    generator = torch.Generator(device=device).manual_seed(seed)

    def uniform(low: float, high: float, *shape) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=generator, device=device, dtype=dtype)

    tower = ray_tower(device, dtype)
    targets = torch.arange(heliostats, device=device) % 2
    index = torch.arange(heliostats, device=device, dtype=dtype)
    rows = -(-heliostats // columns)
    east = (index % columns - (columns - 1) / 2) * 4.5
    north = 100.0 + (rows - 1 - torch.div(index, columns, rounding_mode="floor")) * row_spacing
    centre = torch.stack([east, north, torch.full_like(east, 1.7)], dim=-1)
    half = torch.tensor([1.6, 0.0, 1.25], dtype=dtype, device=device)
    origins = torch.ones((heliostats, points, 4), dtype=dtype, device=device)
    origins[..., :3] = centre[:, None, :] + torch.stack(
        [uniform(-1.6, 1.6, heliostats, points), uniform(-0.05, 0.05, heliostats, points),
         uniform(-1.25, 1.25, heliostats, points)], dim=-1)
    reach = torch.tensor([7.0, 3.0], dtype=dtype, device=device)[targets][:, None]
    aim = tower.planar_centers[targets][:, None, :3].expand(heliostats, points, 3).clone()
    aim[..., 0] += reach * uniform(-1.0, 1.0, heliostats, points)
    aim[..., 2] += reach * uniform(-1.0, 1.0, heliostats, points)
    preferred = torch.zeros_like(origins)
    preferred[..., :3] = torch.nn.functional.normalize(aim - origins[..., :3], dim=-1)
    sample = 0.01 * torch.randn((heliostats, rays, points, 2), generator=generator, device=device, dtype=dtype)
    edge_origins, edge_directions = ray_edge_cases(dtype)
    edges = min(points, edge_origins.shape[0])
    origins[0, :edges] = edge_origins[:edges].to(device)
    preferred[0, :edges] = edge_directions[:edges].to(device)
    sample[0, :, :edges] = 0.0
    sample[1:2, :1] *= 30.0
    corners = torch.ones((heliostats, 4, 4), dtype=dtype, device=device)
    for k, (de, du) in enumerate(((-1, -1), (-1, 1), (1, 1), (1, -1))):  # ll, ul, ur, lr
        corners[:, k, :3] = centre + half * torch.tensor([de, 0.0, du], dtype=dtype, device=device)
    return dict(
        preferred=preferred, origins=origins, distortions_u=sample[..., 0], distortions_e=sample[..., 1],
        tower=tower, targets=targets, magnitudes=uniform(0.5, 2.0, heliostats, 1, 1),
        primitives=blocking_rectangle(corners), own=torch.arange(heliostats, device=device),
        candidates=BLOCKED_CANDIDATES, bitmap=RAY_BITMAP, extinction=RAY_EXTINCTION,
        reflectivity=DEFAULT_MIRROR_REFLECTIVITY,
    )


def blocked_trace_arguments(inputs: dict, start: int = 0, stop: int | None = None) -> tuple:
    """The ray kernels' and their plain versions' arguments for heliostats ``[start, stop)``."""
    stop = inputs["preferred"].shape[0] if stop is None else stop
    magnitude = inputs["magnitudes"]
    if isinstance(magnitude, torch.Tensor) and magnitude.numel() > 1:
        magnitude = magnitude[start:stop]
    return (inputs["preferred"][start:stop], inputs["origins"][start:stop], inputs["distortions_u"][start:stop],
            inputs["distortions_e"][start:stop], inputs["tower"], inputs["targets"][start:stop], magnitude,
            inputs["bitmap"])


def blocked_route_sigma(inputs: dict, directions, distances, statistics) -> tuple[torch.Tensor, torch.Tensor]:
    """The route's sigma ``[M, N]`` from the kernels' (or plain) rays and statistics, and the kept
    candidates' mask ``[M, K]``, as ``render.blocked_splat_inputs`` computes them."""
    corners, spans, normals = inputs["primitives"]
    origins = inputs["origins"]
    table = primitive_table(corners, spans, normals, blocking_module.EPSILON).to(origins.dtype)
    indices, valid = blocking_module.select_blocking_candidates(
        origins, None, corners, inputs["own"], None, inputs["candidates"], statistics=statistics,
    )
    columns, keep = candidate_columns(table, indices, valid, distances.numel())
    sigma = blocking_kernels.blocking_sigma(
        origins, directions, distances, columns, keep, blocking_module.SOFTNESS, blocking_module.RAY_ORIGIN_OFFSET,
        blocking_module.EPSILON,
    )
    return sigma, kept_sets(indices, valid)


def kept_sets(indices: torch.Tensor, valid: torch.Tensor) -> list[list[int]]:
    """Each heliostat's kept candidates, sorted."""
    return [sorted(i for i, k in zip(row, keep) if k) for row, keep in zip(indices.tolist(), valid.tolist())]


def aten_kept_candidates(inputs: dict) -> list[list[int]]:
    """The kept candidates of the PyTorch chain (``ray_splat_inputs``' rays into
    ``select_blocking_candidates``), by BLOCKED_PLAIN_HELIOSTATS heliostats."""
    kept = []
    config = RenderConfig(bitmap_resolution=inputs["bitmap"])
    num = inputs["preferred"].shape[0]
    corners = inputs["primitives"][0]
    for start in range(0, num, BLOCKED_PLAIN_HELIOSTATS):
        stop = min(num, start + BLOCKED_PLAIN_HELIOSTATS)
        preferred, origins, du, de, tower, targets, magnitude, _ = blocked_trace_arguments(inputs, start, stop)
        with torch.no_grad():
            chain = ray_splat_inputs(tower, preferred, origins, targets, du, de, magnitude, config)
            indices, valid = blocking_module.select_blocking_candidates(
                origins, chain.ray_directions, corners, inputs["own"][start:stop], chain.distances,
                inputs["candidates"],
            )
        kept += kept_sets(indices, valid)
        del chain
    return kept


def statistics_err(ours, theirs, start: int, stop: int) -> float:
    """The largest gap of the kernel's statistics (heliostats ``[start, stop)``) from the plain
    version's: lengths (centre, radius, farthest distance) over the largest of them, the unit
    mean direction and least cosine as they are. Both sum 10^4-10^5 fp32 terms for the centre
    and the mean, in other orders, and the radius inherits the centre's rounding."""
    lengths = (theirs.center, theirs.radius, theirs.farthest)
    scale = max(float(x.abs().max()) for x in lengths)
    gaps = [_max_abs_err(a[start:stop], b) / scale for a, b in zip((ours.center, ours.radius, ours.farthest), lengths)]
    gaps += [_max_abs_err(ours.mean_direction[start:stop], theirs.mean_direction),
             _max_abs_err(ours.least_cosine[start:stop], theirs.least_cosine)]
    return max(gaps)


def _relative_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return _max_abs_err(a, b) / scale if scale > 0 else _max_abs_err(a, b)


def check_blocked_rays(label: str, inputs: dict) -> dict:
    """Phase 20 at one chunk: each kernel against its plain version (by
    BLOCKED_PLAIN_HELIOSTATS heliostats), two launches of each bit-equal, the kept candidates
    equal to the PyTorch chain's, launches counted. Returns the errors and counts."""
    arguments = blocked_trace_arguments(inputs)
    num, rays, points = inputs["distortions_u"].shape
    resolution = inputs["bitmap"]
    before = dict(blocked_rays.LAUNCHES)
    forward = blocked_rays.trace_forward_cuda(*arguments)
    again = blocked_rays.trace_forward_cuda(*arguments)
    statistics = blocked_rays.corridor_statistics_cuda(*arguments[:4], forward[6])
    statistics_again = blocked_rays.corridor_statistics_cuda(*arguments[:4], again[6])
    sigma, kept = blocked_route_sigma(inputs, forward[0], forward[1], statistics)
    constants = (blocking_module.ALPHA, inputs["extinction"], inputs["reflectivity"])
    w, counts = blocked_rays.epilogue_cuda(forward[4], sigma, *constants)
    w_again, counts_again = blocked_rays.epilogue_cuda(forward[4], sigma, *constants)
    generator = torch.Generator(device=sigma.device).manual_seed(SEED + 200)
    grad_w = torch.randn(w.shape, generator=generator, device=w.device)
    cotangents = (torch.randn((num, rays * points, 4), generator=generator, device=w.device),
                  *(torch.randn(w.shape, generator=generator, device=w.device) for _ in range(2)))
    epilogue_grads = blocked_rays.epilogue_backward_cuda(grad_w, forward[4], sigma, *constants)
    epilogue_grads_again = blocked_rays.epilogue_backward_cuda(grad_w, forward[4], sigma, *constants)
    grads = blocked_rays.trace_backward_cuda(*arguments, *cotangents, epilogue_grads[0])
    grads_again = blocked_rays.trace_backward_cuda(*arguments, *cotangents, epilogue_grads[0])
    torch.cuda.synchronize()
    counted = {name: blocked_rays.LAUNCHES[name] - before[name] for name in before}
    if counted != dict.fromkeys(before, 2):
        raise AssertionError(f"phase 20 {label}: launched {counted}, expected 2 of each")
    pairs = dict(blocked_trace_forward=(forward, again), corridor_statistics=(statistics, statistics_again),
                 blocked_epilogue=((w, counts), (w_again, counts_again)),
                 blocked_epilogue_backward=(epilogue_grads, epilogue_grads_again),
                 blocked_trace_backward=(grads, grads_again))
    differ = [name for name, (first, second) in pairs.items()
              if not all(torch.equal(a, b) for a, b in zip(first, second))]
    if differ:
        raise AssertionError(f"phase 20 {label}: two launches of {differ} differ")
    if kept != aten_kept_candidates(inputs):
        raise AssertionError(f"phase 20 {label}: the kept candidates differ from the PyTorch chain's")

    errors = dict(directions=0.0, distances=0.0, coordinates=0.0, intensities=0.0, statistics=0.0, w=0.0,
                  grad_intensities=0.0, grad_sigma=0.0, preferred=0.0, origins=0.0, validity_flips=0, count_gap=0)
    scale = dict(intensities=float(forward[4].abs().max()), w=float(w.abs().max()),
                 grad_intensities=float(epilogue_grads[0].abs().max()),
                 grad_sigma=float(epilogue_grads[1].abs().max()), preferred=float(grads[0].abs().max()),
                 origins=float(grads[1].abs().max()))
    for start in range(0, num, BLOCKED_PLAIN_HELIOSTATS):
        stop = min(num, start + BLOCKED_PLAIN_HELIOSTATS)
        part = blocked_trace_arguments(inputs, start, stop)
        plain = blocked_rays.trace_forward_plain(*part)
        kernel = [x[start:stop] for x in forward[:6]]
        invalid = [(x[2] == resolution[0] - 1) & (x[3] == 0) & (x[4] == 0) for x in (plain, kernel)]
        flips = invalid[0] != invalid[1]
        errors["validity_flips"] += int(flips.sum())
        keep = ~flips
        errors["directions"] = max(errors["directions"], _max_abs_err(kernel[0][..., :3], plain[0][..., :3]))
        errors["distances"] = max(errors["distances"], _relative_err(kernel[1], plain[1]))
        errors["coordinates"] = max(errors["coordinates"], _max_abs_err(kernel[2][keep], plain[2][keep]),
                                    _max_abs_err(kernel[3][keep], plain[3][keep]))
        errors["intensities"] = max(errors["intensities"], _max_abs_err(kernel[4][keep], plain[4][keep]))
        errors["count_gap"] = max(errors["count_gap"], int((kernel[5] - plain[5]).abs().max()))
        reference = blocked_rays.corridor_statistics_plain(part[1], plain[0], plain[1], rays)
        errors["statistics"] = max(errors["statistics"], statistics_err(statistics, reference, start, stop))
        sigma_part = sigma[start:stop]
        plain_w, plain_counts = blocked_rays.epilogue_plain(forward[4][start:stop], sigma_part, *constants)
        errors["w"] = max(errors["w"], _max_abs_err(w[start:stop], plain_w))
        errors["count_gap"] = max(errors["count_gap"], int((counts[:, start:stop] - plain_counts).abs().max()))
        plain_epilogue = blocked_rays.epilogue_backward_plain(grad_w[start:stop], forward[4][start:stop], sigma_part,
                                                              *constants)
        errors["grad_intensities"] = max(errors["grad_intensities"],
                                         _max_abs_err(epilogue_grads[0][start:stop], plain_epilogue[0]))
        errors["grad_sigma"] = max(errors["grad_sigma"], _max_abs_err(epilogue_grads[1][start:stop], plain_epilogue[1]))
        plain_grads = blocked_rays.trace_backward_plain(
            *part, *(c[start:stop] for c in cotangents), epilogue_grads[0][start:stop]
        )
        errors["preferred"] = max(errors["preferred"], _max_abs_err(grads[0][start:stop], plain_grads[0]))
        errors["origins"] = max(errors["origins"], _max_abs_err(grads[1][start:stop], plain_grads[1]))
        del plain, kernel, invalid, reference, plain_w, plain_epilogue, plain_grads
    failures = []
    if errors["validity_flips"] or errors["count_gap"]:
        failures.append(f"{errors['validity_flips']} rays valid on one side only, counts apart by {errors['count_gap']}")
    if errors["coordinates"] > RAY_COORDINATE_TOLERANCE:
        failures.append(f"coordinates apart by {errors['coordinates']} px")
    if errors["directions"] > BLOCKED_DIRECTION_TOLERANCE or errors["distances"] > BLOCKED_DIRECTION_TOLERANCE:
        failures.append(f"directions apart by {errors['directions']}, distances by {errors['distances']} (relative)")
    if errors["statistics"] > BLOCKED_STATISTICS_TOLERANCE:
        failures.append(f"statistics apart by {errors['statistics']} (relative)")
    for key, tolerance in (("intensities", RAY_INTENSITY_TOLERANCE), ("w", RAY_INTENSITY_TOLERANCE),
                           ("grad_intensities", RAY_INTENSITY_TOLERANCE), ("grad_sigma", RAY_INTENSITY_TOLERANCE),
                           ("preferred", BLOCKED_GRADIENT_TOLERANCE), ("origins", BLOCKED_GRADIENT_TOLERANCE)):
        if errors[key] > tolerance * scale[key]:
            failures.append(f"{key} apart by {errors[key]} (scale {scale[key]})")
    if failures:
        raise AssertionError(f"phase 20 {label}: " + "; ".join(failures))
    errors["kept_slots"] = sum(map(len, kept))
    errors["full_heliostats"] = sum(len(k) == inputs["candidates"] for k in kept)
    errors["unblocked_share"] = float(counts[1].sum()) / (num * rays * points)
    return dict(errors=errors, timed=(arguments, forward, sigma, grad_w, cotangents, epilogue_grads, constants))


def time_blocked_rays(inputs: dict, timed: tuple) -> dict[str, dict]:
    """Each kernel of the route at ``inputs``' chunk, by events and from a CUDA graph, against
    its bytes bound (BLOCKED_BYTES)."""
    arguments, forward, sigma, grad_w, cotangents, epilogue_grads, constants = timed
    num, rays, points = inputs["distortions_u"].shape
    calls = {
        "blocked_trace_forward": lambda: blocked_rays.trace_forward_cuda(*arguments),
        "corridor_statistics": lambda: blocked_rays.corridor_statistics_cuda(*arguments[:4], forward[6]),
        "blocked_epilogue": lambda: blocked_rays.epilogue_cuda(forward[4], sigma, *constants),
        "blocked_epilogue_backward": lambda: blocked_rays.epilogue_backward_cuda(grad_w, forward[4], sigma,
                                                                                 *constants),
        "blocked_trace_backward": lambda: blocked_rays.trace_backward_cuda(*arguments, *cotangents,
                                                                           epilogue_grads[0]),
    }
    timings = {}
    for name, fn in calls.items():
        per_ray, per_point = BLOCKED_BYTES[name]
        timing = dict(
            replaces="none (the PyTorch chain around the sigma pair on the compacted blocking route)",
            ms=event_ms(fn, iterations=10), graph_ms=graph_ms(fn, iterations=10),
            bound=bound_ms(per_ray * num * rays * points + per_point * num * points, 0.0), plain_ms=None,
            library_ms=None,
        )
        timings[name] = timing
        _log(
            f"phase 20 {name} at [{num}, {rays}, {points}]: {timing['ms']:.4f} ms by events, "
            f"{timing['graph_ms']:.4f} ms replayed from a CUDA graph, {describe_bound(timing)}, "
            f"{100 * timing['bound'][0] / timing['graph_ms']:.1f}% of it"
        )
    return timings


def blocked_route_launches(device: torch.device) -> dict[str, dict[str, int]]:
    """The route's launches in :func:`small_step` with blocking at SMALL (2 checkpointed ray
    chunks: each forward kernel 3 times a chunk, the forward, its recompute and the render
    without a gradient; each backward once) and with the flat route (none); the ray pair
    launches nothing with blocking."""
    rng = np.random.RandomState(SEED + 20)
    points = 4 * SMALL["surface_points"][0] * SMALL["surface_points"][1]
    distortions = rng.normal(0.0, 1e-2, (2, SMALL["heliostats"], SMALL["rays"], points)).astype(np.float32)
    chunks = SMALL["rays"] // SMALL["ray_chunk"]
    forwards = ("blocked_trace_forward", "corridor_statistics", "blocked_epilogue")
    expected = {
        "compacted": {name: 3 * chunks if name in forwards else chunks for name in blocked_rays.LAUNCHES},
        "flat": dict.fromkeys(blocked_rays.LAUNCHES, 0),
    }
    found = {}
    for label, candidates in (("compacted", CANDIDATES), ("flat", None)):
        blocked_rays.reset_launch_counts()
        ray_kernels.reset_launch_counts()
        small_step(device, distortions, None, SMALL, blocking_active=True, blocking_candidates=candidates)
        found[label] = dict(blocked_rays.LAUNCHES)
        if any(ray_kernels.LAUNCHES.values()):
            raise AssertionError(f"phase 20 {label}: the ray pair launched {ray_kernels.LAUNCHES} with blocking")
    if device.type == "cuda" and found != expected:
        raise AssertionError(f"phase 20: the routes launched {found}, expected {expected}")
    return found


def check_blocked_ray_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 20: the compacted route's kernels on the small grid field (edge rays, a heliostat
    keeping every slot) and on the aim1000.aim_point cell's first chunk, against their plain
    versions; timed there; then the routes' launches. Returns the timings."""
    grid = blocked_chunk_inputs(**BLOCKED_GRID, device=device, seed=SEED + 20)
    checked = check_blocked_rays("grid", grid)
    _log(f"phase 20 grid field {BLOCKED_GRID}: {json.dumps(checked['errors'])}")
    if not checked["errors"]["full_heliostats"]:
        raise AssertionError("phase 20 grid: no heliostat keeps every slot")
    del grid, checked
    inputs = aim1000_chunk_inputs(device)
    checked = check_blocked_rays(BLOCKED_CELL, inputs)
    _log(f"phase 20 {BLOCKED_CELL} first chunk {list(inputs['distortions_u'].shape)}, K = {inputs['candidates']}: "
         f"{json.dumps(checked['errors'])}")
    timings = time_blocked_rays(inputs, checked["timed"])
    del inputs, checked
    empty_cache(device)
    found = blocked_route_launches(device)
    _log(f"phase 20 launches: {json.dumps(found)}")
    return timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if pathlib.Path(artist_tpu_torch.__file__).resolve().parent != REPO / "artist_tpu_torch":
        print("chip_smoke: artist_tpu_torch must sit beside this script", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    _log(f"phase 1 device: {device_name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, TF32 off")
    _log(smi, stamp=False)

    start = time.perf_counter()
    built = build_all()
    build_seconds = time.perf_counter() - start
    report = "; ".join(
        f"{path.name}: " + " | ".join(
            line.strip() for line in output.splitlines() if "registers" in line or "spill" in line
        )
        for path, output in built.values()
    )
    _log(f"phase 2 build: {len(built)} sources in {build_seconds:.2f} s; ptxas (registers, spills): {report}")

    inputs = flagship_inputs(device)
    timings = check_splat_kernels(inputs)
    timings.update(check_dynamic_window_kernels(inputs))
    torch.cuda.empty_cache()
    timings.update(check_formulation_kernels(device))
    torch.cuda.empty_cache()
    timings.update(check_blocking_kernels(device))
    torch.cuda.empty_cache()
    timings.update(check_flat_kernels(device))
    torch.cuda.empty_cache()
    ray_timings = check_ray_kernels(device)
    torch.cuda.empty_cache()
    blocked_ray_timings = check_blocked_ray_kernels(device)
    torch.cuda.empty_cache()
    paths = {"surface_step": drive_surface_step(inputs, LAUNCHES_PER_STEP, "phase 4 surface step")}
    del inputs
    torch.cuda.empty_cache()
    paths["aim_point"] = drive_aim_point(device, AIM_CANDIDATES, "phase 5 aim point")
    torch.cuda.empty_cache()
    paths["blocking_step"] = drive_surface_step(
        flagship_inputs(device, blocking=True), LAUNCHES_PER_BLOCKING_STEP, "phase 6 blocking step"
    )
    torch.cuda.empty_cache()
    check_small_step_against_cpu(device)
    check_small_aim_point_against_cpu(device)
    check_small_window_steps_against_cpu(device)
    check_small_reconstruction_against_cpu(device)
    check_small_mixed_trace_against_cpu(device)
    torch.cuda.empty_cache()
    paths["aim_point_flat"] = drive_aim_point(device, None, "phase 8 flat aim point")
    torch.cuda.empty_cache()
    paths["aim_point_flat_dense"] = drive_aim_point(
        device, None, "phase 8 flat aim point, dense rows", DENSE_ROW_SPACING, DENSE_AIM_EPOCHS
    )
    torch.cuda.empty_cache()
    paths["blocking_step_flat"] = drive_surface_step(
        flagship_inputs(device, blocking=True, candidates=None), LAUNCHES_PER_FLAT_BLOCKING_STEP,
        "phase 9 flat blocking step",
    )
    torch.cuda.empty_cache()
    block_window_inputs = flagship_inputs(device, **BLOCK_WINDOW)
    paths["surface_step_block_window"] = drive_surface_step(
        block_window_inputs, LAUNCHES_PER_BLOCK_WINDOW_STEP, "phase 10 block-window step"
    )
    first, windowed = paths["surface_step"]["losses"][0], paths["surface_step_block_window"]["losses"][0]
    if not abs(windowed - first) <= 1e-5 * abs(first):
        raise AssertionError(f"phase 10: first loss {windowed}, phase 4's {first}")
    reorders = ray_stream_reorders(block_window_inputs)
    _log(f"phase 10 block-window step: {reorders} calls reorder a ray stream in a loss and its backward")
    if reorders:
        raise AssertionError(f"phase 10: the block-window step reorders a ray stream {reorders} times")
    del block_window_inputs
    torch.cuda.empty_cache()
    paths["formulation_tool"] = drive_formulation_tool(device)
    torch.cuda.empty_cache()
    reconstruction_chunk = check_reconstruction_chunk(device)
    torch.cuda.empty_cache()
    paths["surface_reconstruction"] = drive_surface_reconstruction(device)
    for kernel_name, chunk_timings in reconstruction_chunk.items():
        timings[kernel_name]["surface_reconstruction_chunk"] = chunk_timings
    torch.cuda.empty_cache()
    paths["kinematics_alignment"], kinematics_data, known = drive_kinematics_alignment(device)
    torch.cuda.empty_cache()
    kinematics_data, known = flux_driven_samples(device, kinematics_data, known)
    for kernel_name, shape_timings in check_kinematics_kernels(device, KINEMATICS_FLUX, kinematics_data).items():
        timings[kernel_name].update(shape_timings)
    torch.cuda.empty_cache()
    paths["kinematics_raytracing"] = drive_kinematics_raytracing(device, kinematics_data, known)
    torch.cuda.empty_cache()
    check_resume(device)
    torch.cuda.empty_cache()
    paths["plant_aim_point"] = drive_plant_aim_point(device)
    for key, result in drive_xl_step(device).items():
        paths[f"xl_step_{key}"] = result
    lbvh_timings, paths["plant_lbvh"] = check_lbvh(device)
    timings.update(lbvh_timings)
    torch.cuda.empty_cache()
    for kernel_name, shape_timings in check_plant_kernels(device).items():
        timings[kernel_name].update(shape_timings)
    torch.cuda.empty_cache()
    paths["data_ingress"], ingress_group, ingress_tower, ingress_distortions = drive_data_ingress(device)
    ingress_surfaces = paths["data_ingress"].pop("surfaces")
    for kernel_name, shape_timings in check_ingress_kernels(ingress_group, ingress_tower, ingress_distortions).items():
        timings[kernel_name].update(shape_timings)
    del ingress_group, ingress_distortions
    torch.cuda.empty_cache()
    distributed = drive_distributed(device, kinematics_data)
    for mode in ("group_parallel", "nested"):
        for rank in range(2):
            paths[f"distributed_{mode}_rank{rank}"] = distributed[f"{mode}_rank{rank}"]
    torch.cuda.empty_cache()
    for label, run in drive_tutorials(device).items():
        paths[label] = run
    torch.cuda.empty_cache()
    for stage, run in drive_pipeline(device, kinematics_data, known).items():
        paths[f"pipeline_{stage}"] = run
    torch.cuda.empty_cache()
    for label, run in drive_alignment_spread(device, kinematics_data, known)["runs"].items():
        paths[f"alignment_{label}"] = run
    del kinematics_data
    torch.cuda.empty_cache()
    paths.update(drive_tools(device, paths["plant_aim_point"]))
    torch.cuda.empty_cache()
    paint_paths, paint_timings = drive_paint_plots(device, ingress_surfaces)
    paths.update(paint_paths)
    for kernel_name, shape_timings in paint_timings.items():
        timings[kernel_name].update(shape_timings)

    case_keys = {key for _, key, *_ in SIGMA_CASES[1:] + FLAT_CASES[1:]} | {
        "kept_primitives", "fit_fraction", "full_splat_ms", "graph_ms", "zero_pairs", "surface_reconstruction_chunk",
        "kinematics_train", "kinematics_validation", "plant_chunk", "plant_chunk_k32", "with_build_ms", "cull_ms",
        "visits", "data_ingress", "paint_reconstruction", "paint_reconstruction_validation", "layouts",
    }
    kernels = []
    for kernel_name, t in timings.items():
        main_path = MAIN_PATH.get(kernel_name, "aim_point_flat")
        kernels.append(
            {
                "name": kernel_name,
                "route": "cuda",
                "source": f"artist_tpu_torch/kernels/csrc/{SOURCES[kernel_name]}",
                "replaces": t["replaces"],
                "main_path": main_path,
                "launches": paths[main_path]["launches"][kernel_name],
                "launches_by_path": {path: r["launches"][kernel_name] for path, r in paths.items() if "launches" in r},
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
                **{key: t[key] for key in sorted(case_keys) if key in t},
            }
        )
    _log(json.dumps({"kernels": kernels}), stamp=False)
    _log(json.dumps({"ray_kernels": ray_timings}), stamp=False)
    _log(json.dumps({"blocked_ray_kernels": blocked_ray_timings}), stamp=False)
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
         stamp=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
