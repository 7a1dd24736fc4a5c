"""Calibration data ingress (counterpart of ``artist_tpu/io``).

Only the :class:`~artist_tpu_torch.io.calibration.CalibrationData` container
is ported so far; the PAINT, STRAL and checkpoint parsers are not.
"""
