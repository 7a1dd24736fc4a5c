"""The kinematics-reconstruction figures of the PAINT plot (UTIS against HeliOS centroids).

Counterpart of ``examples/paint_plots/reconstruction_plot.py``. From
``kinematics_reconstruction_results.json`` two figures are drawn under ``plots_dir``:

- ``reconstruction_error_distribution.pdf``: histograms and Gaussian KDEs of the
  heliostats' pointing errors for both centroid methods, with their means;
- ``reconstruction_error_distance.pdf``: the pointing error against the heliostat's
  distance from the tower, a seeded subsample, with linear trends.

:func:`error_distribution_data` and :func:`error_distance_data` compute each
figure's arrays; the ``plot_*`` functions draw them with ``matplotlib`` on the host,
with TeX only where ``latex`` is on the path::

    python -m artist_tpu_torch.examples.paint_plots.reconstruction_plot \\
        [--config C] [--results_dir R] [--plots_dir P] [--number_of_points_to_plot N] [--random_seed S]
"""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.reconstruction_generate_results import (
    HELIOS_KEY,
    POSITION_KEY,
    RESULTS_FILE,
    UTIS_KEY,
)

PLOT_COLORS = {HELIOS_KEY: "#1D3557", UTIS_KEY: "#FB8500"}
BINS = 25
KDE_POINTS = 100
TREND_POINTS = 200


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if shutil.which("latex"):
        plt.rcParams["text.usetex"] = True
        plt.rcParams["text.latex.preamble"] = r"\usepackage{cmbright}"
    return plt


def _losses(results: dict) -> dict[str, np.ndarray]:
    return {key: np.array([data[key] for data in results.values()]) for key in (HELIOS_KEY, UTIS_KEY)}


def error_distribution_data(results: dict) -> dict:
    """The first figure's arrays: each method's losses and mean, the histograms' range,
    the KDEs over :data:`KDE_POINTS` points (None where ``scipy`` is missing or the
    losses admit no KDE), and the
    methods in drawing order (the larger mean first, so that the smaller stays visible)."""
    losses = _losses(results)
    x_max = float(max(values.max() for values in losses.values()))
    x_values = np.linspace(0.0, x_max, KDE_POINTS)
    try:
        from scipy.stats import gaussian_kde

        kde = {key: gaussian_kde(values, bw_method="scott")(x_values) for key, values in losses.items()}
    except (ImportError, ValueError, np.linalg.LinAlgError):  # no scipy, or too few distinct losses
        kde = {key: None for key in losses}
    return dict(
        losses=losses,
        means={key: float(values.mean()) for key, values in losses.items()},
        x_max=x_max,
        x_values=x_values,
        kde=kde,
        order=sorted(losses, key=lambda key: -losses[key].mean()),
    )


def error_distance_data(results: dict, number_of_points_to_plot: int, random_seed: int) -> dict:
    """The second figure's arrays: the heliostats' distances from the tower (east and
    north) and their losses, a subsample of ``number_of_points_to_plot`` drawn with
    ``numpy.random.RandomState(random_seed)`` where there are more, and each method's
    linear trend (coefficients, and its line over :data:`TREND_POINTS` points; None
    under two points)."""
    positions = np.array([data[POSITION_KEY] for data in results.values()], dtype=float)
    losses = _losses(results)
    distances = np.linalg.norm(positions[:, :2], axis=1)
    rng = np.random.RandomState(random_seed)
    if number_of_points_to_plot < distances.shape[0]:
        selected = rng.choice(distances.shape[0], number_of_points_to_plot, replace=False)
        distances = distances[selected]
        losses = {key: values[selected] for key, values in losses.items()}
    x_values = np.linspace(distances.min(), distances.max(), TREND_POINTS)
    trends, lines = {}, {}
    for key, values in losses.items():
        trends[key] = np.polyfit(distances, values, 1) if distances.shape[0] >= 2 else None
        lines[key] = None if trends[key] is None else np.poly1d(trends[key])(x_values)
    return dict(distances=distances, losses=losses, x_values=x_values, trends=trends, lines=lines)


def plot_error_distribution(data: dict, save_dir: pathlib.Path) -> pathlib.Path:
    """Draw :func:`error_distribution_data` as ``reconstruction_error_distribution.pdf``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for key in data["order"]:
        ax.hist(data["losses"][key], bins=BINS, range=(0, data["x_max"]), density=True, alpha=0.3,
                label=f"{key} Histogram", color=PLOT_COLORS[key])
    for key in (HELIOS_KEY, UTIS_KEY):
        if data["kde"][key] is not None:
            ax.plot(data["x_values"], data["kde"][key], label=f"{key} KDE", color=PLOT_COLORS[key])
        ax.axvline(data["means"][key], color=PLOT_COLORS[key], linestyle="--",
                   label=f"{key} Mean: {data['means'][key]:.2f} meter")
    ax.set_xlabel("Pointing Error (meter)")
    ax.set_ylabel("Density")
    ax.grid(True)
    ax.legend(fontsize=8)
    path = pathlib.Path(save_dir) / "reconstruction_error_distribution.pdf"
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_error_against_distance(data: dict, save_dir: pathlib.Path) -> pathlib.Path:
    """Draw :func:`error_distance_data` as ``reconstruction_error_distance.pdf``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for key, marker in ((HELIOS_KEY, "o"), (UTIS_KEY, "^")):
        ax.scatter(data["distances"], data["losses"][key], color=PLOT_COLORS[key], marker=marker,
                   label=f"{key} Mean Error", alpha=0.7)
    for key in (HELIOS_KEY, UTIS_KEY):
        if data["lines"][key] is not None:
            ax.plot(data["x_values"], data["lines"][key], color=PLOT_COLORS[key], linestyle="--",
                    label=f"{key} Trend")
    ax.set_xlabel("Heliostat Distance from Tower (meter)")
    ax.set_ylabel("Mean Pointing Error (meter)")
    ax.grid(True)
    ax.legend(fontsize=8, loc="upper right", ncol=2)
    path = pathlib.Path(save_dir) / "reconstruction_error_distance.pdf"
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_reconstruction_results(results: dict, plots_dir: pathlib.Path, number_of_points_to_plot: int,
                                random_seed: int) -> list[pathlib.Path]:
    """Both figures of ``results`` under ``plots_dir``; returns their files."""
    plots_dir = pathlib.Path(plots_dir)
    plots_dir.mkdir(parents=True, exist_ok=True)
    return [
        plot_error_distribution(error_distribution_data(results), plots_dir),
        plot_error_against_distance(error_distance_data(results, number_of_points_to_plot, random_seed), plots_dir),
    ]


def main(argv: list[str] | None = None) -> list[pathlib.Path]:
    args = load_config(
        ["results_dir", "plots_dir", "number_of_points_to_plot", "random_seed"],
        description=__doc__.splitlines()[0], argv=argv,
    )
    path = args.results_dir / RESULTS_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"Reconstruction results at {path} not found; run reconstruction_generate_results first."
        )
    with open(path) as handle:
        results = json.load(handle)
    written = plot_reconstruction_results(
        results, args.plots_dir, int(args.number_of_points_to_plot), int(args.random_seed)
    )
    for plot in written:
        print(f"Saved {plot}")
    return written


if __name__ == "__main__":
    main()
