"""NURBS surface reconstruction from measured flux images.

Counterpart of ``artist_tpu/optim/surface_reconstructor.py``, single
process. For each heliostat group, one train step per epoch: NURBS
evaluation of the calibration samples' control points -> alignment -> ray
trace -> crop around the centre of mass -> flux loss per heliostat, plus an
Augmented-Lagrangian (AL) energy constraint and two dynamically balanced
regularizers -> gradient -> outer-edge lock -> Adam update -> AL multiplier
update. Validation on the held-out samples at the logged epochs.

- Activation is a gather by the sample -> heliostat index map
  (:func:`~artist_tpu_torch.field.heliostat_group.active_indices_from_mask`),
  so the gradients of a heliostat's samples sum into its control points.
- The samples' orientations depend on the sun and the aim point, not on the
  control points: each batch aligns once when it is built, and every epoch
  applies the stored orientations to the freshly evaluated surfaces.
- ``torch.optim.Adam`` (eps 1e-8) takes the place of optax's ``adam(1.0)``
  with its update scaled by the epoch's rate, the same update: the
  scheduler's rate is set on the parameter group each epoch. The edge lock
  acts on the gradient before Adam sees it.
- Sun distortions come from one ``torch.Generator`` seeded with ``seed`` per
  group: the train batch's first, then the test batch's. (The JAX package
  draws them from the two halves of ``jax.random.split(PRNGKey(seed))``.)
- ``checkpoint_dir``: every ``checkpoint_every`` epochs each group's loop
  saves its resume state (control points, Adam state, multipliers, reference
  integrals, scheduler, early stopping, histories) under
  ``surface_group_{i}``, and a new run with the same directory resumes from
  the latest (:mod:`~artist_tpu_torch.optim.checkpointing`).

- ``distributed_setup`` (:func:`~artist_tpu_torch.parallel.setup_distributed_environment`):
  in the group-parallel mode (no more ranks than groups) each rank reconstructs
  its round-robin groups alone; afterwards the groups' results, losses and
  control points are merged on every rank
  (:func:`~artist_tpu_torch.parallel.collectives.synchronize_group_results`) and
  each group reconstructed elsewhere is refreshed from its control points. In the
  nested mode (more ranks than groups), or with a ``mesh`` given, every rank runs
  every group on its slice of the samples (the mesh's ``heliostats`` dim) and of
  the rays (its ``rays`` dim): the ray slices' flux maps are summed before the
  crop, the per-sample losses and flux integrals gathered before the reduction,
  and the control points' gradient summed over the ranks, so every rank takes the
  same step as one process (:class:`~artist_tpu_torch.parallel.mesh.ShardPlan`).
  Each rank draws the whole batch's distortions and keeps its slice.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.flux.bitmap import crop_flux_distributions_around_center
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.optim import checkpointing, losses, training
from artist_tpu_torch.optim.regularizers import ideal_surface_regularizer, smoothness_regularizer
from artist_tpu_torch.parallel import collectives
from artist_tpu_torch.parallel.env import resolve_mesh
from artist_tpu_torch.parallel.mesh import ShardPlan
from artist_tpu_torch.raytracing.render import RenderConfig, compute_ray_magnitude, trace_rays
from artist_tpu_torch.scenario.scenario import Scenario, update_surfaces
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import span

log = logging.getLogger("artist_tpu_torch.optim")

HISTORY_KEYS = (
    "total_loss",
    "flux_loss",
    "smoothness_regularizer",
    "ideal_regularizer",
    "flux_integral",
    "flux_integral_constraint",
)
# The aux entry behind each history key but the total.
_HISTORY_AUX = {
    "flux_loss": "flux_loss",
    "smoothness_regularizer": "smoothness",
    "ideal_regularizer": "ideal",
    "flux_integral": "flux_integral",
    "flux_integral_constraint": "flux_integral_constraint",
}
FLUX_LOSSES = {"kl_divergence": losses.kl_divergence_loss, "pixel": losses.pixel_loss}


def lock_control_points_on_outer_edges(gradients: torch.Tensor) -> torch.Tensor:
    """Zero the u/v gradients of the outer-edge control points (z stays), so the
    facets stay rectangular. ``gradients``: ``[H, F, Cu, Cv, 3]``."""
    num_cu, num_cv = gradients.shape[2], gradients.shape[3]
    rows = torch.arange(num_cu, device=gradients.device)[:, None]
    cols = torch.arange(num_cv, device=gradients.device)[None, :]
    edge = (rows == 0) | (rows == num_cu - 1) | (cols == 0) | (cols == num_cv - 1)
    keep_uv = (~edge).to(gradients.dtype)[None, None, :, :, None]
    mask = torch.cat(
        [keep_uv.expand(gradients[..., :2].shape), torch.ones_like(gradients[..., 2:])], dim=-1
    )
    return gradients * mask


@dataclass
class GroupReconstructionResult:
    """Per-group outcome of a reconstruction run (host numpy)."""

    group_index: int
    loss_history: dict[str, list[float]]
    test_loss: dict[str, np.ndarray]
    final_loss_per_heliostat: np.ndarray  # [active heliostats]
    active_heliostat_indices: np.ndarray  # group-local indices


class SurfaceReconstructor:
    """Reconstruct the NURBS surfaces of all heliostat groups from flux images.

    Parameters
    ----------
    scenario : Scenario
        The scene; its tensors' device is where the reconstruction runs.
    data : dict
        ``{"data_parser": parser, "heliostat_data_mapping": [...]}``; the
        parser implements ``parse_data_for_reconstruction``.
    optimization_configuration : dict
        ``{optimization: {...}, scheduler: {...}, constraints: {...}}``.
    dni : float | None
        Direct normal irradiance in W/m^2; None keeps unit ray magnitudes.
    number_of_surface_points : tuple[int, int]
        NURBS sampling resolution per facet.
    bitmap_resolution : tuple[int, int]
        Flux bitmap resolution (width_e, height_u).
    checkpoint_dir : path | None
        Root of the loops' checkpoints; None saves nothing.
    checkpoint_every : int
        Epochs between checkpoints.
    ray_chunk : int | None
        Chunk of the ray axis of the trace (``RenderConfig.ray_chunk``): each
        chunk is recomputed in the backward, which bounds the step's
        activation memory at production shapes. It must divide each rank's rays.
    mesh : DeviceMesh | None
        Splits every group's samples and rays over the ranks, which all run
        every group; defaults to ``distributed_setup.mesh`` in the nested mode.
    distributed_setup : DistributedSetup | None
        The run's ranks; group-parallel or nested, as its ``is_nested`` says.
    """

    def __init__(
        self,
        scenario: Scenario,
        data: dict[str, Any],
        optimization_configuration: dict[str, Any],
        dni: float | None = None,
        number_of_surface_points: tuple[int, int] = (50, 50),
        bitmap_resolution: tuple[int, int] = (256, 256),
        epsilon: float = 1e-12,
        mesh=None,
        seed: int = 7,
        distributed_setup=None,
        checkpoint_dir=None,
        checkpoint_every: int = 25,
        ray_chunk: int | None = None,
    ) -> None:
        self.distributed_setup = distributed_setup
        self.mesh = resolve_mesh(mesh, distributed_setup)
        self.scenario = scenario
        self.device = scenario.heliostat_groups[0].positions.device
        self.data = data
        self.optimizer_dict = optimization_configuration[constants.optimization]
        self.scheduler_dict = optimization_configuration[constants.scheduler]
        self.constraint_dict = optimization_configuration[constants.constraints]
        self.dni = dni
        self.number_of_surface_points = tuple(number_of_surface_points)
        self.bitmap_resolution = tuple(bitmap_resolution)
        self.epsilon = epsilon
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.ray_chunk = ray_chunk

    # ------------------------------------------------------------------ #

    def _build_step_functions(self, group: hg.HeliostatGroupState, loss_name: str):
        """The train, validation, reference-integral and gradient steps of one group."""
        if loss_name not in FLUX_LOSSES:
            raise ValueError(f"Unknown loss for surface reconstruction: {loss_name}")
        flux_loss_fn = FLUX_LOSSES[loss_name]
        tower = self.scenario.solar_tower
        epsilon = self.epsilon
        evaluation_points = create_nurbs_evaluation_grid(self.number_of_surface_points, device=self.device)
        render_config = RenderConfig(
            bitmap_resolution=self.bitmap_resolution,
            blocking_active=False,
            ray_chunk=self.ray_chunk,
        )
        rho = float(self.constraint_dict[constants.rho_flux_integral])
        energy_tolerance = float(self.constraint_dict[constants.energy_tolerance])
        weight_smoothness = float(self.constraint_dict[constants.weight_smoothness])
        weight_ideal = float(self.constraint_dict[constants.weight_ideal_surface])

        def predict_cropped_flux(control_points: torch.Tensor, batch: dict) -> torch.Tensor:
            """This rank's samples' cropped flux, from all of its rays."""
            plan = batch["plan"]
            with span("artist.aten.nurbs"):
                points, normals = evaluate_nurbs_surfaces(
                    torch.index_select(plan.params(control_points), 0, batch["active_indices"]),
                    group.nurbs_degrees,
                    evaluation_points,
                    canting=batch["canting"],
                    facet_translations=batch["facet_translations"],
                )
            num_samples = batch["active_indices"].shape[0]
            with span("artist.aten.align"):
                aligned_points, aligned_normals = hg.apply_orientations(
                    points.reshape(num_samples, -1, 4),
                    normals.reshape(num_samples, -1, 4),
                    batch["orientations"],
                )
            with span("artist.aten.trace"):
                flux = trace_rays(
                    tower=tower,
                    aligned_surface_points=aligned_points,
                    aligned_surface_normals=aligned_normals,
                    incident_ray_directions=batch["incident_ray_directions"],
                    target_area_indices=batch["target_area_indices"],
                    distortions_u=batch["distortions_u"],
                    distortions_e=batch["distortions_e"],
                    ray_magnitude=batch["ray_magnitude"],
                    config=render_config,
                )[0]
            with span("artist.aten.loss"):
                return crop_flux_distributions_around_center(plan.flux(flux), tower, batch["target_area_indices"])

        def per_heliostat(loss_per_sample: torch.Tensor, batch: dict) -> torch.Tensor:
            return losses.reduce_loss_per_heliostat(
                loss_per_sample, batch["padded_sample_indices"], batch["sample_valid"], "mean"
            )

        def gathered(local_loss: Callable, cropped: torch.Tensor, batch: dict) -> torch.Tensor:
            """Every sample's ``local_loss`` from each rank's cropped flux."""
            return batch["plan"].per_sample(local_loss(cropped, batch["flux_measured"]))

        def loss_terms(
            control_points: torch.Tensor,
            batch: dict,
            flux_integrals_reference: torch.Tensor,
            lambda_flux_integral: torch.Tensor,
            original_control_points: torch.Tensor,
        ):
            cropped = predict_cropped_flux(control_points, batch)
            with span("artist.aten.loss"):
                flux_loss_per_heliostat = per_heliostat(gathered(flux_loss_fn, cropped, batch), batch)

                # Augmented-Lagrangian flux-integral (energy) constraint.
                flux_integrals = batch["plan"].per_sample(torch.sum(cropped, dim=(1, 2)))
                relative_differences = (flux_integrals - flux_integrals_reference) / (
                    flux_integrals_reference + epsilon
                )
                constraint_per_sample = torch.clamp(-energy_tolerance - relative_differences, min=0.0)
                constraint_per_heliostat = per_heliostat(constraint_per_sample, batch)
                flux_integral_constraint = (
                    lambda_flux_integral * constraint_per_heliostat
                    + 0.5 * rho * constraint_per_heliostat**2
                )

                # Dynamically balanced regularizers. alpha and beta stay in the
                # autograd graph, as in the reference: d(alpha * smooth)/d cp then
                # largely cancels once the regularizer dwarfs epsilon, and
                # detaching them changes the optimization trajectory.
                unique_cp = torch.index_select(control_points, 0, batch["unique_heliostats"])
                smooth = smoothness_regularizer(unique_cp, original_control_points)
                ideal = ideal_surface_regularizer(unique_cp, original_control_points)
                mean_flux_loss = torch.mean(flux_loss_per_heliostat)
                alpha = weight_smoothness * mean_flux_loss / (torch.mean(smooth) + epsilon)
                beta = weight_ideal * mean_flux_loss / (torch.mean(ideal) + epsilon)

                total_per_heliostat = (
                    flux_loss_per_heliostat + flux_integral_constraint + alpha * smooth + beta * ideal
                )
                aux = {
                    "total_loss_per_heliostat": total_per_heliostat,
                    "flux_loss": mean_flux_loss,
                    "flux_integral": torch.mean(relative_differences),
                    "smoothness": torch.mean(alpha * smooth),
                    "ideal": torch.mean(beta * ideal),
                    "flux_integral_constraint": torch.mean(flux_integral_constraint),
                    "constraint_per_heliostat": constraint_per_heliostat,
                    "flux_integrals": flux_integrals,
                }
                return torch.mean(total_per_heliostat), aux

        def gradient_step(control_points, lambda_flux_integral, flux_integrals_reference, original_control_points,
                          batch):
            """One evaluation of the full objective: (loss, edge-locked gradient, aux),
            the gradient the train step hands Adam. ``control_points`` is not changed."""
            parameters = control_points.detach().clone().requires_grad_(True)
            loss, aux = loss_terms(
                parameters, batch, flux_integrals_reference, lambda_flux_integral, original_control_points
            )
            loss.backward()
            aux = {key: value.detach() for key, value in aux.items()}
            return loss.detach(), lock_control_points_on_outer_edges(parameters.grad), aux

        def train_step(control_points, optimizer, lambda_flux_integral, flux_integrals_reference,
                       original_control_points, batch, learning_rate: float):
            """One epoch: the objective's gradient, edge-locked, one Adam step at
            ``learning_rate`` on the leaf ``control_points``, and the AL multiplier
            update from the constraint before the step. Returns (multipliers, loss, aux)."""
            with span("artist.optim.update"):
                for param_group in optimizer.param_groups:
                    param_group["lr"] = learning_rate
                optimizer.zero_grad(set_to_none=True)
            loss, aux = loss_terms(
                control_points, batch, flux_integrals_reference, lambda_flux_integral, original_control_points
            )
            with span("artist.aten.backward"):
                loss.backward()
            with span("artist.optim.update"):
                control_points.grad = lock_control_points_on_outer_edges(control_points.grad)
                optimizer.step()
                aux = {key: value.detach() for key, value in aux.items()}
                lambda_flux_integral = torch.clamp(
                    lambda_flux_integral + rho * aux["constraint_per_heliostat"], min=0.0
                )
            return lambda_flux_integral, loss.detach(), aux

        @torch.no_grad()
        def validate_step(control_points: torch.Tensor, batch: dict) -> dict[str, torch.Tensor]:
            cropped = predict_cropped_flux(control_points, batch)
            with span("artist.aten.loss"):
                return {
                    "test_loss_pixel": per_heliostat(gathered(losses.pixel_loss, cropped, batch), batch),
                    "test_loss_kl_divergence": per_heliostat(
                        gathered(losses.kl_divergence_loss, cropped, batch), batch
                    ),
                }

        @torch.no_grad()
        def reference_integrals(control_points: torch.Tensor, batch: dict) -> torch.Tensor:
            cropped = predict_cropped_flux(control_points, batch)
            with span("artist.aten.loss"):
                return batch["plan"].per_sample(torch.sum(cropped, dim=(1, 2)))

        return train_step, validate_step, reference_integrals, gradient_step

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _make_batch(
        self,
        group: hg.HeliostatGroupState,
        mask: np.ndarray,
        incident: np.ndarray,
        targets: np.ndarray,
        flux: np.ndarray,
        generator: torch.Generator,
        sun,
        row_heliostats: np.ndarray,
    ) -> dict:
        """The device tensors of one split: this rank's samples, their orientations and
        sun distortions (the whole split's drawn from ``generator``, then sliced), the
        split's :class:`ShardPlan` and the ragged reduction's matrix over all samples.

        ``row_heliostats`` (group-local indices of the calibration-active
        heliostats) fixes the per-heliostat rows, so the reduction stays
        aligned with the original control points and the AL multipliers also
        where a heliostat has no sample in this split.
        """
        device = self.device
        active_indices = training.to_device(hg.active_indices_from_mask(mask), device, torch.long)
        num_samples = active_indices.shape[0]
        num_points = (
            self.number_of_surface_points[0]
            * self.number_of_surface_points[1]
            * group.number_of_facets_per_heliostat
        )
        # This rank's samples and rays (all of them without a mesh).
        plan = ShardPlan(self.mesh, num_samples, sun.number_of_rays)
        distortions_u, distortions_e = map(plan.distortions, sun.get_distortions(generator, num_points, num_samples))
        if self.dni is not None:
            ray_magnitude = compute_ray_magnitude(self.dni, group.canting, num_points, sun.number_of_rays)
        else:
            ray_magnitude = 1.0
        active_indices = plan.take(active_indices)
        target_indices = plan.take(training.to_device(targets, device, torch.long))
        aim_points = get_centers_of_target_areas(self.scenario.solar_tower, target_indices)
        incident_directions = plan.take(training.to_device(np.asarray(incident, dtype=np.float32), device))
        active = hg.gather_active(group, active_indices)
        orientations = hg.align_surfaces_with_incident_ray_directions(active, aim_points, incident_directions)[2]
        padded, valid = losses.build_sample_index_matrix(np.asarray(mask)[row_heliostats])
        return {
            "plan": plan,
            "active_indices": active_indices,
            "canting": active.canting,
            "facet_translations": active.facet_translations,
            "orientations": orientations,
            "incident_ray_directions": incident_directions,
            "target_area_indices": target_indices,
            "distortions_u": distortions_u,
            "distortions_e": distortions_e,
            "flux_measured": plan.take(training.to_device(np.asarray(flux, dtype=np.float32), device)),
            "ray_magnitude": ray_magnitude,
            "unique_heliostats": training.to_device(row_heliostats, device, torch.long),
            "padded_sample_indices": training.to_device(padded, device, torch.long),
            "sample_valid": training.to_device(valid, device),
        }

    def _batches(self, group, split, unique: np.ndarray, test: bool = True) -> list[dict]:
        """The train batch and, with ``test``, the test batch, their distortions
        drawn in that order from one generator seeded with ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        sun = self.scenario.light_sources[0]
        return [
            self._make_batch(
                group,
                getattr(split, f"active_heliostats_mask_{part}"),
                getattr(split, f"incident_ray_directions_{part}"),
                getattr(split, f"target_area_indices_{part}"),
                getattr(split, f"flux_measured_{part}"),
                generator,
                sun,
                unique,
            )
            for part in (("train", "test") if test else ("train",))
        ]

    def single_step_gradients(
        self,
        loss_definition: str = "kl_divergence",
        lambda_flux_integral: dict[int, np.ndarray] | None = None,
        flux_integrals_reference: dict[int, np.ndarray] | None = None,
    ) -> dict[int, dict[str, np.ndarray]]:
        """One full-objective gradient per group on the train split, updating nothing.

        Returns ``{group_index: {"loss", "gradients", "flux_integrals",
        "lambda_flux_integral"}}``: the exact objective of the train step (flux
        loss, AL energy constraint, balanced regularizers) and its edge-locked
        gradient at the current control points. ``lambda_flux_integral`` and
        ``flux_integrals_reference`` override, per group, the zero multipliers
        and the reference integrals at the current control points (the epoch-0
        state).
        """
        outputs: dict[int, dict[str, np.ndarray]] = {}
        for group_index, group in enumerate(self.scenario.heliostat_groups):
            group_data = training.group_calibration_split(
                self.data, self.scenario, group, self.bitmap_resolution, group_index, self.distributed_setup
            )
            if group_data is None:
                continue
            unique, split = group_data
            (train_batch,) = self._batches(group, split, unique, test=False)
            _, _, reference_integrals, gradient_step = self._build_step_functions(group, loss_definition)
            control_points = group.nurbs_control_points.detach()
            original_control_points = control_points[torch.as_tensor(unique, device=self.device)]
            if flux_integrals_reference is not None and group_index in flux_integrals_reference:
                flux_ref = torch.as_tensor(
                    np.asarray(flux_integrals_reference[group_index], np.float32), device=self.device
                )
            else:
                flux_ref = reference_integrals(control_points, train_batch)
            if lambda_flux_integral is not None and group_index in lambda_flux_integral:
                lambda_flux = torch.as_tensor(
                    np.asarray(lambda_flux_integral[group_index], np.float32), device=self.device
                )
            else:
                lambda_flux = torch.zeros(unique.shape[0], device=self.device)
            loss, gradients, aux = gradient_step(
                control_points, lambda_flux, flux_ref, original_control_points, train_batch
            )
            outputs[group_index] = {
                "loss": loss.cpu().numpy(),
                "gradients": gradients.cpu().numpy(),
                "flux_integrals": aux["flux_integrals"].cpu().numpy(),
                "lambda_flux_integral": lambda_flux.cpu().numpy(),
            }
        return collectives.merge_group_outputs(self.distributed_setup, outputs)

    def reconstruct_surfaces(
        self,
        loss_definition: str = "kl_divergence",
        on_epoch: Callable[[int, float], None] | None = None,
    ) -> tuple[np.ndarray, list[GroupReconstructionResult]]:
        """Run the reconstruction for every heliostat group.

        Per group the loop runs while the loss exceeds ``tolerance`` and the
        epoch is at most ``max_epoch`` (so ``max_epoch + 1`` epochs without a
        stop). It validates when ``epoch % log_step == 0`` (``log_step`` 0
        means ``max_epoch``), at epoch ``max_epoch - 1`` and on an early stop,
        which ends the loop before that epoch enters the history.
        ``on_epoch(epoch, loss)`` is called after each epoch's update, once its
        loss has reached the host.

        Returns
        -------
        tuple
            (the final loss per heliostat over the whole field ``[H_total]``,
            inf where a heliostat has no data; the per-group results). Each
            reconstructed group of the scenario is replaced by one with the new
            control points and its surfaces re-evaluated from them.
        """
        with span("artist.entry.call"):
            return self._reconstruct_surfaces(loss_definition, on_epoch)

    def _reconstruct_surfaces(self, loss_definition: str, on_epoch: Callable[[int, float], None] | None):
        log.info("Beginning surface reconstruction.")
        groups = self.scenario.heliostat_groups
        final_loss = np.full(sum(g.number_of_heliostats for g in groups), np.inf, dtype=np.float32)
        results: list[GroupReconstructionResult] = []
        max_epoch = int(self.optimizer_dict[constants.max_epoch])
        tolerance = float(self.optimizer_dict[constants.tolerance])
        log_step = int(self.optimizer_dict.get(constants.log_step, 0)) or max_epoch
        initial_lr = float(self.optimizer_dict[constants.initial_learning_rate])

        reconstructed_control_points: dict[int, np.ndarray] = {}
        offset = 0
        for group_index, group in enumerate(list(groups)):
            with span("artist.entry.preamble", lambda: str(group_index)):
                group_data = training.group_calibration_split(
                    self.data, self.scenario, group, self.bitmap_resolution, group_index, self.distributed_setup
                )
                if group_data is None:
                    offset += group.number_of_heliostats
                    continue
                unique, split = group_data
                with span("artist.entry.batches"):
                    train_batch, test_batch = self._batches(group, split, unique)
                train_step, validate_step, reference_integrals, _ = self._build_step_functions(group, loss_definition)

                control_points = group.nurbs_control_points.detach().clone().requires_grad_(True)
                original_control_points = control_points.detach()[torch.as_tensor(unique, device=self.device)]
                optimizer = torch.optim.Adam([control_points], lr=initial_lr, betas=(0.9, 0.999), eps=1e-8)
                scheduler = training.make_scheduler(initial_lr, self.scheduler_dict)
                early_stopper = training.EarlyStopping(
                    window_size=int(self.optimizer_dict[constants.early_stopping_window]),
                    patience=int(self.optimizer_dict[constants.early_stopping_patience]),
                    min_improvement=float(self.optimizer_dict[constants.early_stopping_delta]),
                    relative=True,
                )
                flux_ref = reference_integrals(control_points, train_batch)
                lambda_flux = torch.zeros(unique.shape[0], device=self.device)

                history: dict[str, list[float]] = {key: [] for key in HISTORY_KEYS}
                test_loss: dict[str, np.ndarray] = {}
                total_loss = np.inf
                total_per_heliostat = None
                epoch = 0

                checkpointer = None
                if self.checkpoint_dir is not None:
                    checkpointer = checkpointing.LoopCheckpointer(
                        self.checkpoint_dir, f"surface_group_{group_index}", every=self.checkpoint_every,
                        **checkpointing.world_options(self.distributed_setup),
                    )
                    restored = checkpointer.restore_loop(optimizer, scheduler, early_stopper, history)
                    if restored is not None:
                        epoch, total_loss, state = restored
                        with torch.no_grad():
                            control_points.copy_(torch.as_tensor(state["control_points"]))
                        lambda_flux = torch.as_tensor(state["lambda_flux"], device=self.device)
                        flux_ref = torch.as_tensor(state["flux_integrals_reference"], device=self.device)
                        log.info("Resuming surface reconstruction of group %d at epoch %d.", group_index, epoch)

            while total_loss > tolerance and epoch <= max_epoch:
                with span("artist.optim.epoch", lambda: str(epoch)):
                    if isinstance(scheduler, training.ReduceOnPlateau):
                        learning_rate = scheduler.learning_rate
                    else:
                        learning_rate = float(scheduler(epoch))
                    lambda_flux, loss, aux = train_step(
                        control_points, optimizer, lambda_flux, flux_ref, original_control_points, train_batch,
                        learning_rate,
                    )
                    # One host transfer per epoch for the loss and the history.
                    with span("artist.optim.fetch"):
                        fetched = torch.stack([loss] + [aux[key] for key in _HISTORY_AUX.values()]).tolist()
                    total_loss = fetched[0]
                    total_per_heliostat = aux["total_loss_per_heliostat"]
                    if isinstance(scheduler, training.ReduceOnPlateau):
                        scheduler.step(total_loss)
                    stop = early_stopper.step(total_loss)
                    if epoch % log_step == 0 or epoch == max_epoch - 1 or stop:
                        log.info("Epoch: %d, Loss: %.6f", epoch, total_loss)
                        with span("artist.optim.validate"):
                            test_loss = {
                                key: value.cpu().numpy()
                                for key, value in validate_step(control_points, test_batch).items()
                            }
                    if on_epoch is not None:
                        on_epoch(epoch, total_loss)
                    if stop:
                        log.info("Early stopping at epoch %d.", epoch)
                        break
                    history["total_loss"].append(total_loss)
                    for key, value in zip(_HISTORY_AUX, fetched[1:]):
                        history[key].append(value)
                    if checkpointer is not None and checkpointer.should_save(epoch):
                        checkpointer.save_loop(
                            epoch, optimizer, scheduler, early_stopper, history, total_loss,
                            control_points=control_points.detach().cpu().numpy(),
                            lambda_flux=lambda_flux.cpu().numpy(),
                            flux_integrals_reference=flux_ref.cpu().numpy(),
                        )
                    epoch += 1
            groups[group_index] = update_surfaces(
                group.replace(nurbs_control_points=control_points.detach()), self.number_of_surface_points
            )
            reconstructed_control_points[group_index] = control_points.detach().cpu().numpy()
            per_heliostat = (
                total_per_heliostat.cpu().numpy()
                if total_per_heliostat is not None
                else np.full(unique.shape[0], np.inf, np.float32)
            )
            final_loss[offset + unique] = per_heliostat
            results.append(
                GroupReconstructionResult(
                    group_index=group_index,
                    loss_history=history,
                    test_loss=test_loss,
                    final_loss_per_heliostat=per_heliostat,
                    active_heliostat_indices=unique,
                )
            )
            offset += group.number_of_heliostats
            log.info("Surfaces reconstructed for group %d.", group_index)

        final_loss, results, merged = collectives.synchronize_group_results(
            self.distributed_setup, final_loss, results, reconstructed_control_points
        )
        for group_index, control_points in merged.items():
            if group_index not in reconstructed_control_points:
                groups[group_index] = update_surfaces(
                    groups[group_index].replace(nurbs_control_points=torch.as_tensor(control_points, device=self.device)),
                    self.number_of_surface_points,
                )
        return final_loss, results
