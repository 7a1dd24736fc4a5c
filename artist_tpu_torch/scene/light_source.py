"""Light source base definitions (counterpart of ``artist_tpu/scene/light_source.py``).

A light source is a small config dataclass plus a sampling method driven by a
``torch.Generator``; :class:`artist_tpu_torch.scene.sun.Sun` is the only
concrete model.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LightSource:
    """Common light-source configuration."""

    number_of_rays: int
