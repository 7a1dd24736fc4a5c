"""Kinematics calibration: reconstruct the heliostats' rotation deviations.

Counterpart of ``artist_tpu/optim/kinematics_reconstructor.py``, single
process. The optimized leaf is each group's ``[H, 4]`` rotation deviations;
the calibration samples gather them by the sample -> heliostat index map, so
the gradients of a heliostat's samples sum into its row. Two methods:

- ``raytracing`` (flux driven): align each sample with its measured motor
  positions, trace its rays onto the target in one call over the whole split
  (no ray chunks, as the JAX package), and compare the flux with the measured
  one (``focal_spot``, ``kl_divergence`` or ``pixel``); the median over a
  heliostat's samples is its loss. ``focal_spot`` holds the flux's centre of
  mass to the measured flux's, as the JAX package does, or, with
  ``focal_spot_ground_truth="focal_spots"``, to the calibration's measured focal
  spots (the centroids a PAINT parser read, UTIS or HeliOS). Each epoch
  launches the splat forward once and its backward once.
- ``alignment``: no ray is traced in training. The predicted normal (the
  orientation's third column) of each sample is held against the normal its
  measured focal spot implies (``angle`` or ``cosine_similarity``), averaged
  over a heliostat's samples.

Both validate on the test split by tracing it (one splat forward) when
``epoch % log_step == 0``, at epoch ``max_epoch - 1`` and on an early stop.
The gradient is scrubbed of NaN and infinities (set to 0) before Adam sees
it: ``angle_loss``'s derivative is infinite where a predicted normal equals
the measured one in fp32.

- ``torch.optim.Adam`` (eps 1e-8), with the scheduler's rate set on its
  parameter group each epoch, takes the place of optax's ``adam(1.0)``
  scaled by the rate: the same update.
- Sun distortions come from one ``torch.Generator`` seeded with ``seed`` per
  group: the train batch's first, then the test batch's. The alignment
  method draws the train batch's too, so that both methods validate on the
  same rays, and frees them.
- Each batch gathers the per-sample copy of its group once; an epoch gathers
  only the rotation deviations.
- ``checkpoint_dir``: every ``checkpoint_every`` epochs each group's loop
  saves its resume state under ``kinematics_group_{i}``, and a new run with
  the same directory resumes from the latest
  (:mod:`~artist_tpu_torch.optim.checkpointing`).
- The configuration's ``batch_size`` is not read, as in the JAX package.

- ``distributed_setup``: in the group-parallel mode each rank reconstructs its
  round-robin groups alone, and the groups' results, losses and rotation
  deviations are merged on every rank afterwards. In the nested mode, or with a
  ``mesh`` given, every rank runs every group on its slice of the samples and
  rays: the ray slices' flux maps are summed, every sample's loss is gathered
  before the per-heliostat reduction (the median needs them all), and the
  deviations' gradient is summed over the ranks
  (:class:`~artist_tpu_torch.parallel.mesh.ShardPlan`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field import kinematics_rigid_body as rigid_body
from artist_tpu_torch.geometry.transforms import _normalize
from artist_tpu_torch.optim import checkpointing, losses, training
from artist_tpu_torch.parallel import collectives
from artist_tpu_torch.parallel.env import resolve_mesh
from artist_tpu_torch.parallel.mesh import ShardPlan
from artist_tpu_torch.raytracing.render import RenderConfig, compute_ray_magnitude, trace_rays
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import span

log = logging.getLogger("artist_tpu_torch.optim")

FLUX_LOSSES = ("focal_spot", "kl_divergence", "pixel")
FOCAL_SPOT_GROUND_TRUTHS = ("flux", "focal_spots")
ALIGNMENT_LOSSES = ("angle", "cosine_similarity")
# The validation's losses: result key -> flux loss.
VALIDATION_LOSSES = {"pixel_loss": "pixel", "kl_div": "kl_divergence", "focal_spot_loss": "focal_spot"}


def compute_measured_normals(
    heliostat_positions: torch.Tensor,
    focal_spots_measured: torch.Tensor,
    incident_ray_directions: torch.Tensor,
) -> torch.Tensor:
    """The unit normals ``[S, 4]`` (w = 0) that reflect each sample's incident
    direction from its heliostat onto its measured focal spot (all ``[S, 4]``)."""
    preferred = _normalize(focal_spots_measured[:, :3] - heliostat_positions[:, :3])
    normals3 = _normalize(preferred - incident_ray_directions[:, :3])
    return torch.cat([normals3, torch.zeros_like(normals3[:, :1])], dim=1)


@dataclass
class GroupKinematicsResult:
    """Per-group outcome of a kinematics reconstruction run (host numpy)."""

    group_index: int
    loss_history: list[float]
    test_loss: dict[str, np.ndarray]
    final_loss_per_heliostat: np.ndarray  # [active heliostats]
    active_heliostat_indices: np.ndarray  # group-local indices


class KinematicsReconstructor:
    """Reconstruct the rotation deviations of all heliostat groups.

    Parameters
    ----------
    scenario : Scenario
        The scene; its tensors' device is where the reconstruction runs.
    data : dict
        ``{"data_parser": parser, "heliostat_data_mapping": [...]}``; the
        parser implements ``parse_data_for_reconstruction``.
    optimization_configuration : dict
        ``{optimization: {...}, scheduler: {...}}``.
    reconstruction_method : str
        ``"raytracing"`` or ``"alignment"``.
    dni : float | None
        Direct normal irradiance in W/m^2; None keeps unit ray magnitudes.
    bitmap_resolution : tuple[int, int]
        Flux bitmap resolution (width_e, height_u).
    checkpoint_dir : path | None
        Root of the loops' checkpoints; None saves nothing.
    checkpoint_every : int
        Epochs between checkpoints.
    mesh : DeviceMesh | None
        Splits every group's samples and rays over the ranks, which all run
        every group; defaults to ``distributed_setup.mesh`` in the nested mode.
    distributed_setup : DistributedSetup | None
        The run's ranks; group-parallel or nested, as its ``is_nested`` says.
    focal_spot_ground_truth : str
        What the ``focal_spot`` loss holds a traced flux's centre of mass to:
        ``"flux"``, the measured flux's centre of mass (the JAX package's), or
        ``"focal_spots"``, the calibration data's measured focal spots.
    """

    def __init__(
        self,
        scenario: Scenario,
        data: dict[str, Any],
        optimization_configuration: dict[str, Any],
        reconstruction_method: str = constants.kinematics_reconstruction_raytracing,
        dni: float | None = None,
        bitmap_resolution: tuple[int, int] = (256, 256),
        mesh=None,
        seed: int = 7,
        distributed_setup=None,
        checkpoint_dir=None,
        checkpoint_every: int = 25,
        focal_spot_ground_truth: str = "flux",
    ) -> None:
        if focal_spot_ground_truth not in FOCAL_SPOT_GROUND_TRUTHS:
            raise ValueError(
                f"focal_spot_ground_truth must be one of {FOCAL_SPOT_GROUND_TRUTHS}, got {focal_spot_ground_truth!r}"
            )
        self.focal_spot_ground_truth = focal_spot_ground_truth
        self.mesh = resolve_mesh(mesh, distributed_setup)
        self.distributed_setup = distributed_setup
        if reconstruction_method not in (
            constants.kinematics_reconstruction_raytracing,
            constants.kinematics_reconstruction_alignment,
        ):
            raise ValueError(
                f"The kinematics reconstruction method '{reconstruction_method}' is "
                f"unknown. Please select another reconstruction method and try again!"
            )
        self.scenario = scenario
        self.device = scenario.heliostat_groups[0].positions.device
        self.data = data
        self.optimizer_dict = optimization_configuration[constants.optimization]
        self.scheduler_dict = optimization_configuration[constants.scheduler]
        self.reconstruction_method = reconstruction_method
        self.dni = dni
        self.bitmap_resolution = tuple(bitmap_resolution)
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)

    @property
    def _flux_driven(self) -> bool:
        return self.reconstruction_method == constants.kinematics_reconstruction_raytracing

    def _default_loss(self, loss_definition: str | None) -> str:
        if loss_definition is not None:
            return loss_definition
        return "focal_spot" if self._flux_driven else "angle"

    # ------------------------------------------------------------------ #

    def _active(self, rotation_deviations: torch.Tensor, batch: dict) -> hg.HeliostatGroupState:
        """The batch's per-sample group (this rank's samples) with the samples' rows of
        ``rotation_deviations``, read through the batch's plan."""
        return batch["active"].replace(
            rotation_deviations=torch.index_select(batch["plan"].params(rotation_deviations), 0, batch["active_indices"])
        )

    def _trace_flux(self, rotation_deviations: torch.Tensor, batch: dict) -> torch.Tensor:
        """Align each of this rank's samples with its measured motor positions and trace
        its flux ``[S, H, W]`` from all of its rays."""
        with span("artist.aten.align"):
            points, normals, _ = hg.align_surfaces_with_motor_positions(
                self._active(rotation_deviations, batch), batch["motor_positions"]
            )
        with span("artist.aten.trace"):
            flux = trace_rays(
                tower=self.scenario.solar_tower,
                aligned_surface_points=points,
                aligned_surface_normals=normals,
                incident_ray_directions=batch["incident_ray_directions"],
                target_area_indices=batch["target_area_indices"],
                distortions_u=batch["distortions_u"],
                distortions_e=batch["distortions_e"],
                ray_magnitude=batch["ray_magnitude"],
                config=RenderConfig(bitmap_resolution=self.bitmap_resolution, blocking_active=False),
            )[0]
        return batch["plan"].flux(flux)

    def _flux_loss_per_sample(self, loss_name: str, flux: torch.Tensor, batch: dict) -> torch.Tensor:
        if loss_name == "kl_divergence":
            return losses.kl_divergence_loss(flux, batch["flux_measured"])
        if loss_name == "pixel":
            return losses.pixel_loss(flux, batch["flux_measured"])
        if loss_name == "focal_spot":
            ground_truth = batch["flux_measured" if self.focal_spot_ground_truth == "flux" else "focal_spots_measured"]
            return losses.focal_spot_loss(flux, ground_truth, self.scenario.solar_tower, batch["target_area_indices"])
        raise ValueError(f"Unknown loss for kinematics reconstruction: {loss_name}")

    def _build_step_functions(self, loss_name: str):
        """The train, validation and gradient steps of the method with ``loss_name``."""
        if self._flux_driven and loss_name not in FLUX_LOSSES:
            raise ValueError(f"Unknown loss for kinematics reconstruction: {loss_name}")
        if not self._flux_driven and loss_name not in ALIGNMENT_LOSSES:
            raise ValueError(f"Unknown loss for alignment-driven reconstruction: {loss_name}")
        reduction = "median" if self._flux_driven else "mean"

        def per_heliostat(loss_per_sample: torch.Tensor, batch: dict) -> torch.Tensor:
            return losses.reduce_loss_per_heliostat(
                loss_per_sample, batch["padded_sample_indices"], batch["sample_valid"], reduction
            )

        def objective(rotation_deviations: torch.Tensor, batch: dict):
            if self._flux_driven:
                flux = self._trace_flux(rotation_deviations, batch)
            else:
                with span("artist.aten.align"):
                    active = self._active(rotation_deviations, batch)
                    orientations = rigid_body.motor_positions_to_orientations(
                        motor_positions=batch["motor_positions"],
                        heliostat_positions=active.positions,
                        translation_deviations=active.translation_deviations,
                        rotation_deviations=active.rotation_deviations,
                        actuator_type=active.actuator_type,
                        actuator_non_optimizable=active.actuator_non_optimizable,
                        actuator_optimizable=active.actuator_optimizable,
                    )
            with span("artist.aten.loss"):
                if self._flux_driven:
                    per_sample = self._flux_loss_per_sample(loss_name, flux, batch)
                else:
                    normals = orientations[:, :, 2]  # the orientation applied to the z axis
                    measured = batch["normals_measured"]
                    if loss_name == "angle":
                        per_sample = losses.angle_loss(normals, measured)
                    else:
                        per_sample = losses.cosine_similarity_loss(normals[:, :3], measured[:, :3])
                loss_per_heliostat = per_heliostat(batch["plan"].per_sample(per_sample), batch)
                return torch.mean(loss_per_heliostat), loss_per_heliostat

        def scrubbed(gradients: torch.Tensor) -> torch.Tensor:
            return torch.nan_to_num(gradients, nan=0.0, posinf=0.0, neginf=0.0)

        def train_step(rotation_deviations, optimizer, batch: dict, learning_rate: float):
            """One epoch on the leaf ``rotation_deviations``: the objective's scrubbed
            gradient and one Adam step at ``learning_rate``. Returns (loss, per heliostat)."""
            with span("artist.optim.update"):
                for param_group in optimizer.param_groups:
                    param_group["lr"] = learning_rate
                optimizer.zero_grad(set_to_none=True)
            loss, loss_per_heliostat = objective(rotation_deviations, batch)
            with span("artist.aten.backward"):
                loss.backward()
            with span("artist.optim.update"):
                rotation_deviations.grad = scrubbed(rotation_deviations.grad)
                optimizer.step()
            return loss.detach(), loss_per_heliostat.detach()

        def gradient_step(rotation_deviations: torch.Tensor, batch: dict):
            """One evaluation of the objective: (loss, scrubbed gradient, per heliostat),
            the gradient the train step hands Adam. ``rotation_deviations`` is not changed."""
            parameters = rotation_deviations.detach().clone().requires_grad_(True)
            loss, loss_per_heliostat = objective(parameters, batch)
            loss.backward()
            return loss.detach(), scrubbed(parameters.grad), loss_per_heliostat.detach()

        @torch.no_grad()
        def validate_step(rotation_deviations: torch.Tensor, batch: dict) -> dict[str, torch.Tensor]:
            flux = self._trace_flux(rotation_deviations, batch)
            with span("artist.aten.loss"):
                return {
                    key: per_heliostat(batch["plan"].per_sample(self._flux_loss_per_sample(loss, flux, batch)), batch)
                    for key, loss in VALIDATION_LOSSES.items()
                }

        return train_step, validate_step, gradient_step

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _make_batch(self, group: hg.HeliostatGroupState, split, part: str, generator, unique: np.ndarray,
                    traced: bool) -> dict:
        """The device tensors of one split (``part``: "train" or "test"): this rank's
        samples, their per-sample copy of the group, the measured normals and sun
        distortions (the whole split's drawn from ``generator``, then sliced; kept
        only where ``traced``), the split's plan and the ragged reduction's matrix over
        the heliostats ``unique``."""
        device = self.device
        mask = getattr(split, f"active_heliostats_mask_{part}")
        active_indices = training.to_device(hg.active_indices_from_mask(mask), device, torch.long)
        num_points = group.surface_points.shape[1]
        sun = self.scenario.light_sources[0]
        # This rank's samples and rays (all of them without a mesh). A batch that is not
        # traced has no rays to split: the ranks of a ray slice share its samples' work.
        plan = ShardPlan(self.mesh, active_indices.shape[0], sun.number_of_rays if traced else 1)
        distortions_u, distortions_e = sun.get_distortions(generator, num_points, active_indices.shape[0])
        if traced:
            distortions_u, distortions_e = plan.distortions(distortions_u), plan.distortions(distortions_e)
        else:
            distortions_u = distortions_e = None
        active_indices = plan.take(active_indices)
        if self.dni is not None:
            ray_magnitude = compute_ray_magnitude(self.dni, group.canting, num_points, sun.number_of_rays)
        else:
            ray_magnitude = 1.0

        def tensor(name: str, dtype=torch.float32) -> torch.Tensor:
            return plan.take(training.to_device(getattr(split, f"{name}_{part}"), device, dtype))

        active = hg.gather_active(group, active_indices)
        incident = tensor("incident_ray_directions")
        focal_spots = tensor("focal_spots_measured")
        padded, valid = losses.build_sample_index_matrix(np.asarray(mask)[unique])
        return {
            "plan": plan,
            "active_indices": active_indices,
            "active": active,
            "incident_ray_directions": incident,
            "target_area_indices": tensor("target_area_indices", torch.long),
            "flux_measured": tensor("flux_measured"),
            "motor_positions": tensor("motor_positions"),
            "focal_spots_measured": focal_spots,
            "normals_measured": compute_measured_normals(active.positions, focal_spots, incident),
            "distortions_u": distortions_u,
            "distortions_e": distortions_e,
            "ray_magnitude": ray_magnitude,
            "padded_sample_indices": training.to_device(padded, device, torch.long),
            "sample_valid": training.to_device(valid, device),
        }

    def _batches(self, group, split, unique: np.ndarray, test: bool = True) -> list[dict]:
        """The train batch and, with ``test``, the test batch, their distortions
        drawn in that order from one generator seeded with ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        return [
            self._make_batch(group, split, part, generator, unique, traced=self._flux_driven or part == "test")
            for part in (("train", "test") if test else ("train",))
        ]

    def single_step_gradients(self, loss_definition: str | None = None) -> dict[int, dict[str, np.ndarray]]:
        """One objective gradient per group on the train split, updating nothing.

        Returns ``{group_index: {"loss", "gradients"}}``: the train step's
        objective and its scrubbed gradient ``[H, 4]`` at the current rotation
        deviations. The default loss is ``focal_spot`` for the raytracing
        method and ``angle`` for the alignment method.
        """
        loss_definition = self._default_loss(loss_definition)
        outputs: dict[int, dict[str, np.ndarray]] = {}
        for group_index, group in enumerate(self.scenario.heliostat_groups):
            group_data = training.group_calibration_split(
                self.data, self.scenario, group, self.bitmap_resolution, group_index, self.distributed_setup
            )
            if group_data is None:
                continue
            unique, split = group_data
            (train_batch,) = self._batches(group, split, unique, test=False)
            _, _, gradient_step = self._build_step_functions(loss_definition)
            loss, gradients, _ = gradient_step(group.rotation_deviations, train_batch)
            outputs[group_index] = {"loss": loss.cpu().numpy(), "gradients": gradients.cpu().numpy()}
        return collectives.merge_group_outputs(self.distributed_setup, outputs)

    def reconstruct_kinematics(
        self,
        loss_definition: str | None = None,
        on_epoch: Callable[[int, float], None] | None = None,
    ) -> tuple[np.ndarray, list[GroupKinematicsResult]]:
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
            (the final train loss per heliostat over the whole field
            ``[H_total]``, inf where a heliostat has no data; the per-group
            results). Each reconstructed group of the scenario is replaced by
            one with the new rotation deviations.
        """
        with span("artist.entry.call"):
            return self._reconstruct_kinematics(self._default_loss(loss_definition), on_epoch)

    def _reconstruct_kinematics(self, loss_definition: str, on_epoch: Callable[[int, float], None] | None):
        log.info("Beginning kinematics reconstruction with %s.", self.reconstruction_method)
        groups = self.scenario.heliostat_groups
        final_loss = np.full(sum(g.number_of_heliostats for g in groups), np.inf, dtype=np.float32)
        results: list[GroupKinematicsResult] = []
        max_epoch = int(self.optimizer_dict[constants.max_epoch])
        tolerance = float(self.optimizer_dict[constants.tolerance])
        log_step = int(self.optimizer_dict.get(constants.log_step, 0)) or max_epoch
        initial_lr = float(self.optimizer_dict[constants.initial_learning_rate_rotation_deviation])

        reconstructed_deviations: dict[int, np.ndarray] = {}
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
                train_step, validate_step, _ = self._build_step_functions(loss_definition)

                rotation_deviations = group.rotation_deviations.detach().clone().requires_grad_(True)
                optimizer = torch.optim.Adam([rotation_deviations], lr=initial_lr, betas=(0.9, 0.999), eps=1e-8)
                scheduler = training.make_scheduler(initial_lr, self.scheduler_dict)
                early_stopper = training.EarlyStopping(
                    window_size=int(self.optimizer_dict[constants.early_stopping_window]),
                    patience=int(self.optimizer_dict[constants.early_stopping_patience]),
                    min_improvement=float(self.optimizer_dict[constants.early_stopping_delta]),
                    relative=True,
                )

                history: list[float] = []
                test_loss: dict[str, np.ndarray] = {}
                loss_value = np.inf
                per_heliostat = None
                epoch = 0

                checkpointer = None
                if self.checkpoint_dir is not None:
                    checkpointer = checkpointing.LoopCheckpointer(
                        self.checkpoint_dir, f"kinematics_group_{group_index}", every=self.checkpoint_every,
                        **checkpointing.world_options(self.distributed_setup),
                    )
                    restored = checkpointer.restore_loop(optimizer, scheduler, early_stopper, history)
                    if restored is not None:
                        epoch, loss_value, state = restored
                        with torch.no_grad():
                            rotation_deviations.copy_(torch.as_tensor(state["rotation_deviations"]))
                        log.info("Resuming kinematics reconstruction of group %d at epoch %d.", group_index, epoch)

            while loss_value > tolerance and epoch <= max_epoch:
                with span("artist.optim.epoch", lambda: str(epoch)):
                    if isinstance(scheduler, training.ReduceOnPlateau):
                        learning_rate = scheduler.learning_rate
                    else:
                        learning_rate = float(scheduler(epoch))
                    loss, per_heliostat = train_step(rotation_deviations, optimizer, train_batch, learning_rate)
                    with span("artist.optim.fetch"):
                        loss_value = loss.item()
                    if isinstance(scheduler, training.ReduceOnPlateau):
                        scheduler.step(loss_value)
                    stop = early_stopper.step(loss_value)
                    if epoch % log_step == 0 or epoch == max_epoch - 1 or stop:
                        log.info("Epoch: %d, Loss: %.6f", epoch, loss_value)
                        with span("artist.optim.validate"):
                            test_loss = {
                                key: value.cpu().numpy()
                                for key, value in validate_step(rotation_deviations.detach(), test_batch).items()
                            }
                    if on_epoch is not None:
                        on_epoch(epoch, loss_value)
                    if stop:
                        log.info("Early stopping at epoch %d.", epoch)
                        break
                    history.append(loss_value)
                    if checkpointer is not None and checkpointer.should_save(epoch):
                        checkpointer.save_loop(
                            epoch, optimizer, scheduler, early_stopper, history, loss_value,
                            rotation_deviations=rotation_deviations.detach().cpu().numpy(),
                        )
                    epoch += 1

            groups[group_index] = group.replace(rotation_deviations=rotation_deviations.detach())
            reconstructed_deviations[group_index] = rotation_deviations.detach().cpu().numpy()
            per_heliostat_np = (
                per_heliostat.cpu().numpy()
                if per_heliostat is not None
                else np.full(unique.shape[0], np.inf, np.float32)
            )
            final_loss[offset + unique] = per_heliostat_np
            results.append(
                GroupKinematicsResult(
                    group_index=group_index,
                    loss_history=history,
                    test_loss=test_loss,
                    final_loss_per_heliostat=per_heliostat_np,
                    active_heliostat_indices=unique,
                )
            )
            offset += group.number_of_heliostats
            log.info("Kinematics reconstructed for group %d.", group_index)

        final_loss, results, merged = collectives.synchronize_group_results(
            self.distributed_setup, final_loss, results, reconstructed_deviations
        )
        for group_index, deviations in merged.items():
            if group_index not in reconstructed_deviations:
                groups[group_index] = groups[group_index].replace(
                    rotation_deviations=torch.as_tensor(deviations, device=self.device)
                )
        return final_loss, results
