"""Field-level flux shaping via motor positions: the aim-point optimizer.

Counterpart of ``artist_tpu/optim/aim_point_optimizer.py:47-719``, single
process. Each epoch aligns every heliostat group from its reparameterized
motor positions, builds the blocking primitives from the aligned surfaces of
the whole field, traces with blocking on (the compacted candidate route with
K = ``blocking_candidates``, or the flat route over every primitive with the
AABB cull when it is None or 0), sums the flux on the chosen target and applies
the KL (or pixel) loss plus three Augmented-Lagrangian constraints: the flux
integral must not drop below its epoch-0 value, no heliostat's intercept may
drop, and no pixel may exceed the maximum flux density.

- The tanh reparameterization ``motor = initial + tanh(p) * scale``, with
  ``scale`` the smaller margin to the motor limits (at least 1), keeps
  relative update sizes comparable across heliostats and bounds each motor's
  excursion.
- ``torch.optim.Adam`` (eps 1e-8) takes the place of optax's ``adam(1.0)``
  scaled by the learning rate: the update formula is the same. The
  scheduler's rate is set on the parameter group each epoch.
- Sun distortions come from a ``torch.Generator`` seeded with ``seed``.
- ``checkpoint_dir``: every ``checkpoint_every`` epochs the loop saves its
  resume state (tanh parameters, Adam state, multipliers, epoch-0
  references, scheduler, early stopping, histories) under ``aim_point``, and
  a new run with the same directory resumes from the latest
  (:mod:`~artist_tpu_torch.optim.checkpointing`).
- ``heliostat_chunk``: each group's heliostat axis is cut into chunks of
  this many heliostats, each run under a checkpoint
  (:mod:`~artist_tpu_torch.parallel.microbatch`), so the backward keeps one
  chunk's aligned surfaces and per-ray tensors at a time. Blocking stays
  field-wide and exact: phase 1 maps every chunk to its 4-corner primitives,
  phase 2 traces each chunk against the whole field's primitives, summing
  the target flux and stitching the per-heliostat factors back together. A
  group of at most ``heliostat_chunk`` heliostats, or one the chunk does not
  divide (with a warning), runs unchunked.

- ``distributed_setup`` (:func:`~artist_tpu_torch.parallel.setup_distributed_environment`),
  group-parallel mode (no more ranks than groups): each rank optimizes and
  traces its round-robin groups alone. Every epoch the ranks exchange the
  blocking primitives of their heliostats (so each traces against the whole
  field) and sum their flux contributions on the target; in the backward each
  rank's cotangent of a primitive is summed back to the rank that owns it. So a
  rank's gradient is that of one process, blocking across ranks included (the
  JAX package exchanges motor positions, re-aligns every group on every rank and
  holds the other ranks' flux constant in the backward). Tolerance, the
  plateau scheduler and early stopping read rank 0's loss. Checkpoints are per
  rank, under ``aim_point_rank{r}``. At the end every rank takes every group's
  motor positions.
- Nested mode (more ranks than groups), or a ``mesh`` given: every rank
  optimizes every group on its slice of each group's heliostats and of the
  rays (:class:`~artist_tpu_torch.parallel.mesh.ShardPlan`): the primitives are
  gathered over the heliostat slices, the flux maps summed over every slice,
  the factors combined, and the parameters' gradient summed over the ranks.
  ``heliostat_chunk`` is ignored on a mesh of more than one rank, with a
  warning: the mesh splits the heliostat axis instead.

Spans (:func:`~artist_tpu_torch.util.logging_utils.span`), as in the reconstructors:
``artist.entry.call`` around :meth:`AimPointOptimizer.optimize`, ``artist.entry.preamble``
from the pre-alignment to the loop's first epoch (the sun's sample, the epoch-0
references, the optimizer), ``artist.optim.epoch`` a loop iteration with ``.update``
(the rate and ``zero_grad``; Adam's step and the multipliers) and ``.fetch`` (the
epoch's one ``.tolist()``) inside, ``artist.aten.trace`` around the forward (both
phases: the primitives and the trace), ``artist.aten.align`` around each alignment
inside it (a checkpointed chunk's recompute runs it again in the backward),
``artist.aten.loss`` around the loss terms and ``artist.aten.backward`` around
``loss.backward()``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.optim import checkpointing, losses, training
from artist_tpu_torch.parallel import collectives
from artist_tpu_torch.parallel.env import is_group_parallel, resolve_mesh, runs_group
from artist_tpu_torch.parallel.mesh import ShardPlan
from artist_tpu_torch.parallel.microbatch import chunked_map, chunked_sum_and_map
from artist_tpu_torch.raytracing.blocking import create_blocking_primitives_rectangles_by_index
from artist_tpu_torch.raytracing.render import (
    RenderConfig,
    compute_ray_magnitude,
    get_bitmaps_per_target,
    trace_rays,
)
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.util import constants, indices
from artist_tpu_torch.util.logging_utils import span

log = logging.getLogger("artist_tpu_torch.optim")

HISTORY_KEYS = (
    "total_loss",
    "flux_loss",
    "local_flux_constraint",
    "intercept_constraint",
    "flux_integral_constraint",
    "flux_integral",
)


class AimPointOptimizer:
    """Optimize motor positions so the field's total flux matches a target distribution.

    Parameters
    ----------
    scenario : Scenario
        The scene; its tensors' device is where the optimization runs.
    optimization_configuration : dict
        ``{optimization: {...}, scheduler: {...}, constraints: {...}}``.
    incident_ray_direction : array-like
        The common incident ray direction ``[4]``.
    target_area_index : int
        Global index of the target area receiving the flux.
    ground_truth : array-like
        Target flux distribution ``[height_u, width_e]``.
    dni : float
        Direct normal irradiance in W/m^2.
    blocking_candidates : int | None
        Candidate blockers per heliostat (K) of the compacted blocking route
        (default 16); None or 0 selects the flat route over every primitive of
        the field, O(rays x field) instead of O(rays x K).
    checkpoint_dir : path | None
        Root of the loop's checkpoints; None saves nothing.
    checkpoint_every : int
        Epochs between checkpoints.
    heliostat_chunk : int | None
        Heliostats a chunk of each group's checkpointed align-and-trace
        (None: no chunks); a group whose heliostat count it does not divide
        runs unchunked, with a warning.
    distributed_setup : DistributedSetup | None
        The run's ranks; group-parallel or nested, as its ``is_nested`` says.
    mesh : DeviceMesh | None
        Splits every group's heliostats and rays over the ranks, which all run
        every group; defaults to ``distributed_setup.mesh`` in the nested mode.
    """

    def __init__(
        self,
        scenario: Scenario,
        optimization_configuration: dict[str, Any],
        incident_ray_direction,
        target_area_index: int,
        ground_truth,
        dni: float,
        bitmap_resolution: tuple[int, int] = (256, 256),
        epsilon: float = 1e-12,
        seed: int = 7,
        distributed_setup=None,
        mesh=None,
        checkpoint_dir=None,
        checkpoint_every: int = 25,
        blocking_candidates: int | None = 16,
        heliostat_chunk: int | None = None,
    ) -> None:
        self.mesh = mesh = resolve_mesh(mesh, distributed_setup)
        self.distributed_setup = distributed_setup
        self.scenario = scenario
        self.device = scenario.heliostat_groups[0].positions.device
        self.blocking_candidates = int(blocking_candidates) if blocking_candidates else None
        self.heliostat_chunk = int(heliostat_chunk) if heliostat_chunk else None
        if self.heliostat_chunk and mesh is not None and mesh.size() > 1:
            log.warning(
                "heliostat_chunk is ignored on a mesh of %d ranks: the mesh splits the heliostat axis instead.",
                mesh.size(),
            )
            self.heliostat_chunk = None
        self.optimizer_dict = optimization_configuration[constants.optimization]
        self.scheduler_dict = optimization_configuration[constants.scheduler]
        self.constraint_dict = optimization_configuration[constants.constraints]
        self.incident_ray_direction = torch.as_tensor(
            np.asarray(incident_ray_direction, dtype=np.float32), device=self.device
        )
        self.target_area_index = int(target_area_index)
        self.ground_truth = torch.as_tensor(
            np.asarray(ground_truth, dtype=np.float32), device=self.device
        )
        self.dni = float(dni)
        self.bitmap_resolution = tuple(bitmap_resolution)
        self.epsilon = epsilon
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)

    def _target_plane_dimensions(self) -> np.ndarray:
        """Physical (width, height) of the chosen target area."""
        tower = self.scenario.solar_tower
        n_planar = tower.number_of_planar_target_areas
        if self.target_area_index < n_planar:
            return tower.planar_dimensions[self.target_area_index].cpu().numpy()
        c = self.target_area_index - n_planar
        return np.asarray(
            [
                float(tower.cylindrical_radii[c]) * float(tower.cylindrical_opening_angles[c]),
                float(tower.cylindrical_heights[c]),
            ]
        )

    @torch.no_grad()
    def _initialize_group_parameters(self, owned: list[int]):
        """Pre-align the groups ``owned``: their initial motor positions, tanh scales and
        per-group inputs, in lists over every group (None where not owned)."""
        count = len(self.scenario.heliostat_groups)
        initial_motor_positions, scales, params, targets, incident = ([None] * count for _ in range(5))
        for g in owned:
            group = self.scenario.heliostat_groups[g]
            num = group.number_of_heliostats
            target_indices = torch.full(
                (num,), self.target_area_index, dtype=torch.long, device=self.device
            )
            directions = self.incident_ray_direction.expand(num, 4)
            active = hg.gather_active(group, torch.arange(num, device=self.device))
            aim = get_centers_of_target_areas(self.scenario.solar_tower, target_indices)
            motor_positions = hg.align_surfaces_with_incident_ray_directions(
                active, aim, directions
            )[3]
            minimum = group.actuator_non_optimizable[:, indices.actuator_min_motor_position]
            maximum = group.actuator_non_optimizable[:, indices.actuator_max_motor_position]
            initial_motor_positions[g] = motor_positions
            scales[g] = torch.clamp(
                torch.minimum(motor_positions - minimum, maximum - motor_positions), min=1.0
            )
            params[g] = torch.zeros_like(motor_positions)
            targets[g] = target_indices
            incident[g] = directions
        return params, scales, initial_motor_positions, targets, incident

    def objective(self, loss_definition: str = "kl_divergence"):
        """The optimization problem, from the scenario's current state.

        Pre-aligns the groups this rank optimizes (every group, but only its own in
        the group-parallel mode; their initial motor positions and tanh scales are
        also kept as ``initial_motor_positions_all_groups`` and
        ``scales_all_groups``, None for the others) and samples the sun
        distortions of every group in order, keeping this rank's.

        Returns
        -------
        tuple
            ``params``: a zero ``[H_g, 2]`` tanh parameter per group this rank
            optimizes; ``forward(params)``: the target's total flux ``[height_u,
            width_e]`` and the intercept, on-target and blocking factors of every
            heliostat of the field; ``loss_fn(params, references, lambdas)``: the
            loss and a dict of its parts, with ``references`` = (flux integral,
            intercepts) of epoch 0 and ``lambdas`` the three multipliers
            (integral, intercept, local flux). Every rank gets the same flux,
            factors and loss.
        """
        if loss_definition not in ("kl_divergence", "pixel"):
            raise ValueError(f"Unknown loss for aim point optimization: {loss_definition}")
        groups = list(self.scenario.heliostat_groups)
        tower = self.scenario.solar_tower
        sun = self.scenario.light_sources[0]
        setup = self.distributed_setup
        group_parallel = is_group_parallel(setup)
        owned = [g for g in range(len(groups)) if runs_group(setup, g)]
        all_params, scales, initial_motor_positions, target_indices, incident_dirs = (
            self._initialize_group_parameters(owned)
        )
        params = [all_params[g] for g in owned]
        # Exposed for inspection.
        self.initial_motor_positions_all_groups = initial_motor_positions
        self.scales_all_groups = scales

        # This rank's heliostats and rays of each group it traces (all of them
        # without a mesh), the group's inputs sliced alike.
        plans = {g: ShardPlan(self.mesh, groups[g].number_of_heliostats, sun.number_of_rays) for g in owned}
        local_indices = {
            g: torch.arange(groups[g].number_of_heliostats, device=self.device)[plans[g].sample_slice] for g in owned
        }
        targets_local = {g: plans[g].take(target_indices[g]) for g in owned}
        incident_local = {g: plans[g].take(incident_dirs[g]) for g in owned}
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        distortions, ray_magnitudes = {}, {}
        for g, group in enumerate(groups):
            num_points = group.surface_points.shape[1]
            pair = sun.get_distortions(generator, num_points, group.number_of_heliostats)
            if g in plans:
                distortions[g] = tuple(plans[g].distortions(d) for d in pair)
                ray_magnitudes[g] = compute_ray_magnitude(self.dni, group.canting, num_points, sun.number_of_rays)
            del pair

        max_flux_density_per_pixel = float(
            np.prod(self._target_plane_dimensions())
            / np.prod(self.bitmap_resolution)
            * self.constraint_dict[constants.max_flux_density]
        )
        rho_local, rho_integral, rho_intercept = self._rhos()
        epsilon = self.epsilon
        use_constraints = loss_definition == "kl_divergence"
        render_config = RenderConfig(
            bitmap_resolution=self.bitmap_resolution,
            blocking_active=True,
            blocking_candidates=self.blocking_candidates,
        )
        number_of_target_areas = tower.number_of_target_areas
        group_sizes = [g.number_of_heliostats for g in groups]
        group_offsets = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])

        # The group-parallel exchange: each rank's block holds its groups' heliostats
        # in group order; ``field_order`` puts the blocks' rows in field order.
        world = collectives.world_group() if group_parallel else None
        if group_parallel:
            ranks = range(setup.world_size)
            block_groups = [g for rank in ranks for g in sorted(setup.groups_to_ranks_mapping[rank])]
            block_sizes = [sum(group_sizes[g] for g in setup.groups_to_ranks_mapping[rank]) for rank in ranks]
            block_offsets = dict(zip(block_groups, np.cumsum([0] + [group_sizes[g] for g in block_groups])))
            field_order = torch.cat(
                [torch.arange(group_sizes[g], device=self.device) + int(block_offsets[g]) for g in range(len(groups))]
            )

        def field_wide(tensor: torch.Tensor, exchange) -> torch.Tensor:
            """Every heliostat's rows, in field order, from this rank's groups' rows."""
            if not group_parallel:
                return tensor
            return exchange(tensor, world, block_sizes).index_select(0, field_order)

        def chunking(group) -> int | None:
            """The group's heliostat chunk, or None to run it unchunked."""
            chunk = self.heliostat_chunk
            if not chunk or group.number_of_heliostats <= chunk:
                return None
            if group.number_of_heliostats % chunk:
                log.warning(
                    "heliostat_chunk=%d does not divide the group's %d heliostats; microbatching is "
                    "DISABLED for this group (it will need the full field's memory).",
                    chunk, group.number_of_heliostats,
                )
                return None
            return chunk

        chunks = {g: chunking(groups[g]) for g in owned}

        def primitives_of(points: torch.Tensor) -> torch.Tensor:
            """The blocking primitives of aligned surfaces, flattened to ``[B, 28]`` rows
            (corners, spans, normals), so that one collective exchanges them."""
            corners, spans, normals = create_blocking_primitives_rectangles_by_index(points)
            return torch.cat([x.reshape(x.shape[0], -1) for x in (corners, spans, normals)], dim=1)

        def forward(group_params):
            with span("artist.aten.trace"):
                return traced_forward(group_params)

        def traced_forward(group_params):
            """Align this rank's groups, trace with field-wide blocking, sum the target's flux.

            A chunked group is aligned chunk by chunk inside the checkpointed
            functions of both phases (so a chunk's gathered state and aligned
            surfaces are recomputed in the backward, not kept); an unchunked
            group is aligned once and its surfaces serve both phases. Every rank
            traces against every heliostat's primitives: those of the heliostats it
            does not align are gathered from the ranks that do, and each rank's
            cotangent of them is summed back to their owner.
            """
            motors = {
                g: initial_motor_positions[g] + torch.tanh(plans[g].params(p)) * scales[g]
                for g, p in zip(owned, group_params)
            }

            def aligned_chunk(g, idx):
                with span("artist.aten.align"):
                    active = hg.gather_active(groups[g], idx)
                    return hg.align_surfaces_with_motor_positions(active, motors[g].index_select(0, idx))[:2]

            blocks, aligned_full = [], {}
            for g in owned:
                if chunks[g]:
                    block = chunked_map(
                        lambda idx, g=g: primitives_of(aligned_chunk(g, idx)[0]), local_indices[g], chunks[g]
                    )
                else:
                    aligned_full[g] = aligned_chunk(g, local_indices[g])
                    block = primitives_of(aligned_full[g][0])
                blocks.append(collectives.gather_for_shards(block, plans[g].sample_group))
            flat = field_wide(torch.cat(blocks), collectives.gather_for_shards)
            primitives = (flat[:, :16].reshape(-1, 4, 4), flat[:, 16:24].reshape(-1, 2, 4), flat[:, 24:])

            total_flux = 0
            intercepts, on_targets, blockings = [], [], []
            for g in owned:
                num_points = groups[g].surface_points.shape[1]

                def traced_chunk(idx, g=g, aligned=None):
                    # An unchunked group (aligned given) reads its tensors whole.
                    def take(x):
                        return x if aligned is not None else x.index_select(0, idx)

                    points, normals = aligned or aligned_chunk(g, idx)
                    targets = take(targets_local[g])
                    flux, intercept, on_target, blocking = trace_rays(
                        tower=tower,
                        aligned_surface_points=points,
                        aligned_surface_normals=normals,
                        incident_ray_directions=take(incident_local[g]),
                        target_area_indices=targets,
                        distortions_u=take(distortions[g][0]),
                        distortions_e=take(distortions[g][1]),
                        ray_magnitude=ray_magnitudes[g],
                        blocking_primitives=primitives,
                        ray_primitive_indices=idx + int(group_offsets[g]),
                        config=render_config,
                    )
                    flux_on_target = get_bitmaps_per_target(flux, targets, number_of_target_areas)[
                        self.target_area_index
                    ]
                    return flux_on_target, (intercept, on_target, blocking)

                if chunks[g]:
                    group_flux, factors = chunked_sum_and_map(traced_chunk, local_indices[g], chunks[g])
                else:
                    group_flux, factors = traced_chunk(local_indices[g], aligned=aligned_full[g])
                total_flux = total_flux + plans[g].sum(group_flux)
                intercept, on_target, blocking = (plans[g].factors(f, num_points) for f in factors)
                intercepts.append(intercept)
                on_targets.append(on_target)
                blockings.append(blocking)
            if group_parallel:
                total_flux = collectives.sum_for_replicated(total_flux, world)
            return (
                total_flux,
                *(field_wide(torch.cat(x), collectives.all_gather_blocks) for x in (intercepts, on_targets, blockings)),
            )

        def loss_fn(group_params, references, lambdas):
            total_flux, intercepts, on_targets, blockings = forward(group_params)
            with span("artist.aten.loss"):
                return loss_terms(total_flux, intercepts, on_targets, blockings, references, lambdas)

        def loss_terms(total_flux, intercepts, on_targets, blockings, references, lambdas):
            loss_of = losses.kl_divergence_loss if use_constraints else losses.pixel_loss
            flux_loss = loss_of(total_flux[None], self.ground_truth[None])[0]
            aux = {
                "flux_loss": flux_loss,
                "total_flux_sum": torch.sum(total_flux),
                "intercepts": intercepts,
                "on_targets": on_targets,
                "blockings": blockings,
            }
            if not use_constraints:
                return flux_loss, aux
            flux_integral_reference, intercept_reference = references
            lambda_integral, lambda_intercept, lambda_local = lambdas

            integral_difference = (flux_integral_reference - torch.sum(total_flux)) / (
                flux_integral_reference + epsilon
            )
            integral_clamped = torch.clamp(integral_difference, min=0.0)
            integral_constraint = (
                lambda_integral * integral_clamped + 0.5 * rho_integral * integral_clamped**2
            )
            intercept_differences = (intercept_reference - intercepts) / (
                intercept_reference + epsilon
            )
            intercept_clamped = torch.clamp(intercept_differences, min=0.0)
            intercept_constraint = torch.mean(
                lambda_intercept * intercept_clamped + 0.5 * rho_intercept * intercept_clamped**2
            )
            local_violation = (total_flux - max_flux_density_per_pixel) / (
                max_flux_density_per_pixel + epsilon
            )
            local_clamped = torch.clamp(local_violation, min=0.0)
            local_constraint = torch.max(
                lambda_local * local_clamped + 0.5 * rho_local * local_clamped**2
            )
            loss = flux_loss + integral_constraint + intercept_constraint + local_constraint
            aux.update(
                flux_integral_constraint=integral_constraint,
                intercept_constraint=intercept_constraint,
                local_flux_constraint=local_constraint,
                flux_integral_difference=integral_difference,
                intercept_differences_mean=torch.mean(intercept_differences),
                local_flux_violation_max=torch.max(local_violation),
            )
            return loss, aux

        return params, forward, loss_fn

    def _rhos(self) -> tuple[float, float, float]:
        """Penalty weights (local flux, flux integral, intercept)."""
        return tuple(
            float(self.constraint_dict[key])
            for key in (constants.rho_local_flux, constants.rho_flux_integral, constants.rho_intercept)
        )

    def optimize(
        self,
        loss_definition: str = "kl_divergence",
        on_epoch: Callable[[int, float], None] | None = None,
    ):
        """Run the aim-point optimization.

        ``on_epoch(epoch, loss)`` is called after each epoch's update, once
        its loss has reached the host.

        Returns
        -------
        tuple
            (final loss, loss history dict, intercept factors, on-target
            factors, blocking factors), the factors from the last epoch's
            forward. The scenario's heliostat groups get the optimized motor
            positions (on every rank, every group's).
        """
        with span("artist.entry.call"):
            return self._optimize(loss_definition, on_epoch)

    def _optimize(self, loss_definition: str, on_epoch: Callable[[int, float], None] | None):
        log.info("Start the aim point optimization.")
        with span("artist.entry.preamble"):
            params, forward, loss_fn = self.objective(loss_definition)
            use_constraints = loss_definition == "kl_divergence"
            rho_local, rho_integral, rho_intercept = self._rhos()
            groups = list(self.scenario.heliostat_groups)
            setup = self.distributed_setup
            owned = [g for g in range(len(groups)) if runs_group(setup, g)]
            # Each rank of a group-parallel run keeps its own groups' loop state.
            if is_group_parallel(setup):
                label, labels = f"aim_point_rank{setup.rank}", {f"aim_point_rank{r}" for r in range(setup.world_size)}
            else:
                label, labels = "aim_point", {"aim_point"}

            # Epoch-0 references (the constraint terms are exactly zero there).
            with torch.no_grad():
                init_flux, init_intercepts, _, _ = forward(params)
            references = (torch.sum(init_flux), init_intercepts)
            zero = torch.zeros((), device=self.device)
            lambdas = (zero, zero, zero)

            for p in params:
                p.requires_grad_(True)
            initial_lr = float(self.optimizer_dict[constants.initial_learning_rate])
            optimizer = torch.optim.Adam(params, lr=initial_lr, betas=(0.9, 0.999), eps=1e-8)
            scheduler = training.make_scheduler(initial_lr, self.scheduler_dict)
            early_stopper = training.EarlyStopping(
                window_size=int(self.optimizer_dict[constants.early_stopping_window]),
                patience=int(self.optimizer_dict[constants.early_stopping_patience]),
                min_improvement=float(self.optimizer_dict[constants.early_stopping_delta]),
                relative=True,
            )
            max_epoch = int(self.optimizer_dict[constants.max_epoch])
            tolerance = float(self.optimizer_dict[constants.tolerance])
            log_step = int(self.optimizer_dict.get(constants.log_step, 0)) or max_epoch

            history: dict[str, list[float]] = {k: [] for k in HISTORY_KEYS}
            loss_value = np.inf
            aux = None
            epoch = 0

            checkpointer = None
            if self.checkpoint_dir is not None:
                checkpointing.refuse_other_worlds(self.checkpoint_dir, labels, "aim_point")
                checkpointer = checkpointing.LoopCheckpointer(
                    self.checkpoint_dir, label, every=self.checkpoint_every, **checkpointing.world_options(setup)
                )
                restored = checkpointer.restore_loop(optimizer, scheduler, early_stopper, history)
                if restored is not None:
                    epoch, loss_value, state = restored
                    with torch.no_grad():
                        for param, value in zip(params, checkpointing.unpack_pytree(state["params"])):
                            param.copy_(value)
                    lambdas = checkpointing.unpack_pytree(state["lambdas"], self.device)
                    references = checkpointing.unpack_pytree(state["references"], self.device)
                    log.info("Resuming aim-point optimization at epoch %d.", epoch)
            reference_integral = float(references[0])

        while loss_value > tolerance and epoch <= max_epoch:
            with span("artist.optim.epoch", lambda: str(epoch)):
                with span("artist.optim.update"):
                    if isinstance(scheduler, training.ReduceOnPlateau):
                        learning_rate = scheduler.learning_rate
                    else:
                        learning_rate = float(scheduler(epoch))
                    for param_group in optimizer.param_groups:
                        param_group["lr"] = learning_rate
                    optimizer.zero_grad(set_to_none=True)
                loss, aux = loss_fn(params, references, lambdas)
                with span("artist.aten.backward"):
                    loss.backward()
                with span("artist.optim.update"):
                    optimizer.step()
                    if use_constraints:
                        # Augmented-Lagrangian multiplier updates.
                        lambdas = tuple(
                            torch.clamp(value + rho * aux[key].detach(), min=0.0)
                            for value, rho, key in zip(
                                lambdas,
                                (rho_integral, rho_intercept, rho_local),
                                ("flux_integral_difference", "intercept_differences_mean",
                                 "local_flux_violation_max"),
                            )
                        )
                scalars = ["flux_loss"]
                if use_constraints:
                    scalars += ["total_flux_sum", "local_flux_constraint", "intercept_constraint",
                                "flux_integral_constraint"]
                with span("artist.optim.fetch"):
                    # One host transfer per epoch for the loss and the history.
                    fetched = torch.stack([loss.detach()] + [aux[k].detach() for k in scalars]).tolist()
                loss_value, values = fetched[0], dict(zip(scalars, fetched[1:]))
                if collectives.is_multiprocess():
                    # Every rank takes the decisions below on rank 0's loss, so that none
                    # stops while another waits in the next epoch's collectives.
                    loss_value = collectives.broadcast_object(loss_value, 0)
                if isinstance(scheduler, training.ReduceOnPlateau):
                    scheduler.step(loss_value)
                if epoch % log_step == 0:
                    log.info("Epoch: %d, Loss: %.6f, LR: %.2e", epoch, loss_value, learning_rate)
                history["total_loss"].append(loss_value)
                history["flux_loss"].append(values["flux_loss"])
                if use_constraints:
                    history["flux_integral"].append(
                        100.0 / reference_integral
                        * (values["total_flux_sum"] - reference_integral + 1e-8)
                    )
                    for key in ("local_flux_constraint", "intercept_constraint", "flux_integral_constraint"):
                        history[key].append(values[key])
                if on_epoch is not None:
                    on_epoch(epoch, loss_value)
                if early_stopper.step(loss_value):
                    log.info("Early stopping at epoch %d.", epoch)
                    break
                if checkpointer is not None and checkpointer.should_save(epoch):
                    checkpointer.save_loop(
                        epoch, optimizer, scheduler, early_stopper, history, loss_value,
                        params=checkpointing.pack_pytree(params),
                        lambdas=checkpointing.pack_pytree(lambdas),
                        references=checkpointing.pack_pytree(references),
                    )
                epoch += 1

        with torch.no_grad():
            motors = {
                g: self.initial_motor_positions_all_groups[g] + torch.tanh(param) * self.scales_all_groups[g]
                for g, param in zip(owned, params)
            }
        if is_group_parallel(setup):
            for rank_motors in collectives.all_gather_object(
                {g: motor.cpu().numpy() for g, motor in motors.items()}
            ):
                motors.update({g: torch.as_tensor(m, device=self.device) for g, m in rank_motors.items() if g not in motors})
        for g, group in enumerate(groups):
            self.scenario.heliostat_groups[g] = group.replace(motor_positions=motors[g].clone())
        log.info("Aim points optimized.")
        if aux is None:
            return loss_value, history, None, None, None
        return (
            loss_value,
            history,
            aux["intercepts"].detach(),
            aux["on_targets"].detach(),
            aux["blockings"].detach(),
        )
