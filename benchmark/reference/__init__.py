"""The benchmark's plain reference: ARTIST's optimization steps written out in plain PyTorch.

Float32 throughout, TF32 off unless a caller asks for it (the control). Nothing
here imports the program under test or JAX: the reference builds its own
surfaces, orientations, rays, flux maps, losses, gradients and Adam updates from
the deployment's numbers and the calibration samples that the traffic generator
made.
"""
