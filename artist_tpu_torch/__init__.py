"""ARTIST on PyTorch and CUDA: the differentiable solar-tower ray tracer for NVIDIA Hopper.

A port of :mod:`artist_tpu` (the JAX package beside it, which stays the
reference) to PyTorch. Plain tensor math is PyTorch; the kernels that the
JAX package writes in Pallas for the TPU are CUDA C++ kernels written by
hand for ``sm_90a`` (see :mod:`artist_tpu_torch.kernels`).

The layout mirrors :mod:`artist_tpu` sub-package by sub-package, so each
module's counterpart is found under the same relative path. Entry points
take an explicit ``device`` and default to ``"cuda"``; nothing moves to the
CPU on its own. Kernel wrappers dispatch on the tensor's device: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
kernel's plain PyTorch version.
"""

__version__ = "0.4.0"
