"""Surface generator: NURBS fitted to deflectometry data, and ideal surfaces.

Counterpart of ``artist_tpu/scenario/surface_generator.py``. The fit runs an
Adam loop (``torch.optim.Adam`` with optax's defaults) on the device of the
point cloud, all facets of a heliostat in one batch through the
scattered-point NURBS evaluation.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from artist_tpu_torch.geometry.coordinates import normalize_points
from artist_tpu_torch.nurbs import create_planar_nurbs_control_points, evaluate_nurbs_surfaces
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import FacetConfig, SurfaceConfig

log = logging.getLogger("artist_tpu_torch.scenario")

# optax.adam's defaults, which the JAX package's fit uses.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class SurfaceGenerator:
    """Generate fitted or ideal surface configurations.

    Attributes
    ----------
    loss_history : list[float]
        The losses of the last :meth:`fit_nurbs` call, one an epoch, each
        taken before that epoch's update.
    """

    def __init__(
        self,
        number_of_control_points: tuple[int, int] = (10, 10),
        degrees: tuple[int, int] = (3, 3),
    ) -> None:
        self.number_of_control_points = tuple(number_of_control_points)
        self.degrees = (int(degrees[0]), int(degrees[1]))
        self.loss_history: list[float] = []

    def fit_nurbs(
        self,
        surface_points: torch.Tensor,
        surface_normals: torch.Tensor,
        initial_learning_rate: float = 1e-3,
        fit_method: str = constants.fit_nurbs_from_normals,
        tolerance: float = 1e-10,
        max_epoch: int = 400,
    ) -> torch.Tensor:
        """Fit NURBS control points to a point cloud or its normals, on its device.

        The loop runs while the loss is above ``tolerance`` and the epoch is
        at most ``max_epoch`` (so up to ``max_epoch + 1`` updates), testing
        the loss taken before each epoch's update; one ``.item()`` an epoch.

        Parameters
        ----------
        surface_points : torch.Tensor
            Homogeneous surface points ``[F, N, 4]`` or ``[N, 4]``.
        surface_normals : torch.Tensor
            Homogeneous surface normals, the same shape.
        initial_learning_rate : float
            Adam's learning rate.
        fit_method : str
            ``point_cloud`` (fit the points) or ``deflectometry`` (fit the normals).
        tolerance, max_epoch :
            Convergence controls.

        Returns
        -------
        torch.Tensor
            Fitted control points ``[F, Cu, Cv, 3]``.
        """
        if fit_method not in (
            constants.fit_nurbs_from_points,
            constants.fit_nurbs_from_normals,
        ):
            raise NotImplementedError(
                f"The conversion method '{fit_method}' is not yet supported in ARTIST."
            )
        if surface_points.dim() == 2:
            surface_points = surface_points[None]
            surface_normals = surface_normals[None]
        device = surface_points.device
        num_facets = surface_points.shape[0]
        num_cu, num_cv = self.number_of_control_points

        # Evaluation parameters: points projected onto the e-n plane,
        # normalised per facet into the open interval (0, 1).
        evaluation_points = torch.stack([normalize_points(p[:, :2]) for p in surface_points])

        # Planar initial control-point grid sized by each facet's extent.
        width = surface_points[:, :, 0].amax(dim=1) - surface_points[:, :, 0].amin(dim=1)
        height = surface_points[:, :, 1].amax(dim=1) - surface_points[:, :, 1].amin(dim=1)
        lin_u = torch.linspace(-0.5, 0.5, num_cu, device=device)
        lin_v = torch.linspace(-0.5, 0.5, num_cv, device=device)
        control_points = torch.zeros((num_facets, num_cu, num_cv, 3), dtype=torch.float32, device=device)
        control_points[..., 0] = width[:, None, None] * lin_u[None, :, None]
        control_points[..., 1] = height[:, None, None] * lin_v[None, None, :]
        control_points.requires_grad_(True)

        fit_points = fit_method == constants.fit_nurbs_from_points
        target = surface_points if fit_points else surface_normals
        optimizer = torch.optim.Adam(
            [control_points], lr=initial_learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS
        )

        self.loss_history = []
        loss = np.inf
        epoch = 0
        while loss > tolerance and epoch <= max_epoch:
            optimizer.zero_grad(set_to_none=True)
            points, normals = evaluate_nurbs_surfaces(
                control_points[None], self.degrees, evaluation_points[None]
            )
            prediction = points[0] if fit_points else normals[0]
            loss_tensor = torch.mean((prediction - target) ** 2)
            loss_tensor.backward()
            optimizer.step()
            loss = loss_tensor.item()
            self.loss_history.append(loss)
            if epoch % 100 == 0:
                log.info("Epoch: %d, Loss: %.3e.", epoch, loss)
            epoch += 1
        return control_points.detach()

    def generate_fitted_surface_config(
        self,
        heliostat_name: str,
        facet_translation_vectors: np.ndarray,
        canting: np.ndarray,
        surface_points_with_facets_list: list[np.ndarray],
        surface_normals_with_facets_list: list[np.ndarray],
        initial_learning_rate: float = 1e-3,
        deflectometry_step_size: int = 100,
        fit_method: str = constants.fit_nurbs_from_normals,
        tolerance: float = 1e-10,
        max_epoch: int = 400,
        device: torch.device | str = "cuda",
    ) -> SurfaceConfig:
        """Fit per-facet NURBS to deflectometry clouds on ``device``.

        Parameters
        ----------
        heliostat_name : str
            Named in the log.
        facet_translation_vectors : np.ndarray
            ``[F, 4]``.
        canting : np.ndarray
            ``[F, 2, 4]``.
        surface_points_with_facets_list, surface_normals_with_facets_list :
            Per-facet clouds ``[N_f, 3]``; every facet is cut to the smallest
            count, then taken every ``deflectometry_step_size``-th point.
        device : torch.device | str
            Where the fit runs.

        Returns
        -------
        SurfaceConfig
            Host numpy facets whose control points are the fit translated by
            the facet translations. A point-cloud fit learns the translations
            itself, so its facets carry zero translations.
        """
        log.info("Beginning generation of the fitted surface configuration.")
        min_points = min(p.shape[0] for p in surface_points_with_facets_list)
        points = np.stack([p[:min_points] for p in surface_points_with_facets_list])
        min_normals = min(n.shape[0] for n in surface_normals_with_facets_list)
        normals = np.stack([n[:min_normals] for n in surface_normals_with_facets_list])
        points = points[:, ::deflectometry_step_size]
        normals = normals[:, ::deflectometry_step_size]

        facet_translation_vectors = np.asarray(facet_translation_vectors, dtype=np.float32)
        if fit_method == constants.fit_nurbs_from_points:
            facet_translation_vectors = np.zeros_like(facet_translation_vectors)

        points4 = np.concatenate([points, np.ones(points.shape[:2] + (1,), np.float32)], axis=-1)
        normals4 = np.concatenate([normals, np.zeros(normals.shape[:2] + (1,), np.float32)], axis=-1)

        log.info("Generating NURBS surface for heliostat: %s.", heliostat_name)
        fitted = self.fit_nurbs(
            torch.tensor(points4, dtype=torch.float32, device=device),
            torch.tensor(normals4, dtype=torch.float32, device=device),
            initial_learning_rate=initial_learning_rate,
            fit_method=fit_method,
            tolerance=tolerance,
            max_epoch=max_epoch,
        ).cpu().numpy()
        facet_config_list = [
            FacetConfig(
                facet_key=f"facet_{i + 1}",
                # The fit learns the facet's shape about the origin; the
                # facet translation moves it to its place on the heliostat.
                control_points=fitted[i] + facet_translation_vectors[i, :3],
                degrees=np.asarray(self.degrees, np.int64),
                translation_vector=facet_translation_vectors[i],
                canting=np.asarray(canting[i], np.float32),
            )
            for i in range(fitted.shape[0])
        ]
        log.info("Surface configuration based on fit complete!")
        return SurfaceConfig(facet_list=facet_config_list)

    def generate_ideal_surface_config(
        self,
        facet_translation_vectors: np.ndarray,
        canting: np.ndarray,
    ) -> SurfaceConfig:
        """Planar control-point grids sized by the canting vectors' norms (host)."""
        control_points = create_planar_nurbs_control_points(
            self.number_of_control_points, torch.tensor(np.asarray(canting, np.float32))
        ).numpy()
        return SurfaceConfig(
            facet_list=[
                FacetConfig(
                    facet_key=f"facet_{i + 1}",
                    control_points=control_points[i],
                    degrees=np.asarray(self.degrees, np.int64),
                    translation_vector=np.asarray(facet_translation_vectors[i], np.float32),
                    canting=np.asarray(canting[i], np.float32),
                )
                for i in range(control_points.shape[0])
            ]
        )
