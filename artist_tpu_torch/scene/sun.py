"""Sun model: Gaussian scatter-angle distortion sampling.

Counterpart of ``artist_tpu/scene/sun.py``. Sampling draws from a
``torch.Generator`` instead of a ``jax.random`` key; the two give different
numbers from one seed, so tests that compare the packages hand both the
same distortions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from artist_tpu_torch.util import constants


@dataclass(frozen=True)
class Sun:
    """Sun light source with a normal scatter-angle distribution.

    Attributes
    ----------
    number_of_rays : int
        Rays sampled per (heliostat, surface point).
    distribution_parameters : dict
        Distribution type, mean and covariance (default: normal, mean 0,
        covariance 4.3681e-06 rad^2).
    """

    number_of_rays: int = 200
    distribution_parameters: dict = field(
        default_factory=lambda: {
            constants.light_source_distribution_type: constants.light_source_distribution_is_normal,
            constants.light_source_mean: 0.0,
            constants.light_source_covariance: 4.3681e-06,
        }
    )

    def __post_init__(self):
        dist_type = self.distribution_parameters[constants.light_source_distribution_type]
        if dist_type != constants.light_source_distribution_is_normal:
            raise ValueError(f"Unknown sun distribution type: {dist_type}")

    def get_distortions(
        self,
        generator: torch.Generator,
        number_of_points: int,
        number_of_active_heliostats: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample scatter-angle distortions on the generator's device.

        Returns
        -------
        tuple of torch.Tensor
            (distortions_u, distortions_e), each
            ``[number_of_active_heliostats, number_of_rays, number_of_points]``.
        """
        mean = self.distribution_parameters[constants.light_source_mean]
        covariance = self.distribution_parameters[constants.light_source_covariance]
        sample = torch.randn(
            (number_of_active_heliostats, self.number_of_rays, number_of_points, 2),
            generator=generator,
            dtype=torch.float32,
            device=generator.device,
        )
        sample = mean + float(covariance) ** 0.5 * sample
        return sample[..., 0], sample[..., 1]
