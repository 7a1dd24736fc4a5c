from artist_tpu_torch.field.heliostat_group import HeliostatGroupState  # noqa: F401
from artist_tpu_torch.field.solar_tower import SolarTower  # noqa: F401
