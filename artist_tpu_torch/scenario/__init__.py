from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5  # noqa: F401
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario  # noqa: F401
