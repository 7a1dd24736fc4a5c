"""Data ingress (counterpart of ``artist_tpu/io``): calibration data, the PAINT
and STRAL parsers, and the optimizers' checkpoints."""
from artist_tpu_torch.io.calibration import (  # noqa: F401
    CalibrationData,
    PaintCalibrationDataParser,
    load_flux_from_png,
)
