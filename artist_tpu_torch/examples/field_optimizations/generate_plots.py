"""Plot the field-optimization results that ``generate_results`` wrote.

Counterpart of ``examples/field_optimizations/generate_plots.py``: the loss
curves of each optimization and, where ``final_flux.npz`` exists, its flux maps.
Runs on the host and needs ``matplotlib``::

    python -m artist_tpu_torch.examples.field_optimizations.generate_plots [config.yaml] [--data-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from artist_tpu_torch.examples.field_optimizations.generate_scenarios import config_arguments, load_config

HISTORY_FILES = {
    "surface reconstruction": "surface_loss_history.json",
    "kinematics reconstruction": "kinematics_loss_history.json",
    "aim-point optimization": "aim_point_loss_history.json",
}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss_histories(results_dir: pathlib.Path, plots_dir: pathlib.Path) -> pathlib.Path | None:
    """``loss_histories.png``: one panel an optimization whose history file exists."""
    present = {title: results_dir / name for title, name in HISTORY_FILES.items() if (results_dir / name).exists()}
    if not present:
        return None
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(present), figsize=(5 * len(present), 4))
    for ax, (title, path) in zip(np.atleast_1d(axes), present.items()):
        with open(path) as handle:
            histories = json.load(handle)
        for key, values in histories.items():
            if isinstance(values, dict):
                for sub_key, sub_values in values.items():
                    ax.plot(sub_values, label=f"{key}/{sub_key}")
            else:
                ax.plot(values, label=key)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.legend(fontsize=7)
    fig.tight_layout()
    out = plots_dir / "loss_histories.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_flux(results_dir: pathlib.Path, plots_dir: pathlib.Path) -> pathlib.Path | None:
    """``flux.png``: each map of ``final_flux.npz``, where that file exists."""
    path = results_dir / "final_flux.npz"
    if not path.exists():
        return None
    plt = _pyplot()
    data = np.load(path)
    names = list(data.keys())
    fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 4))
    for ax, name in zip(np.atleast_1d(axes), names):
        image = ax.imshow(data[name], cmap="inferno")
        ax.set_title(name)
        fig.colorbar(image, ax=ax, shrink=0.8)
    fig.tight_layout()
    out = plots_dir / "flux.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def generate_plots(config: dict) -> list[pathlib.Path]:
    """The plots of ``results_dir`` under ``plots_dir``; returns the files written."""
    results_dir = pathlib.Path(config["results_dir"])
    plots_dir = pathlib.Path(config["plots_dir"])
    plots_dir.mkdir(parents=True, exist_ok=True)
    written = [plot(results_dir, plots_dir) for plot in (plot_loss_histories, plot_flux)]
    print(f"plots written to {plots_dir}")
    return [path for path in written if path is not None]


def main(argv: list[str] | None = None) -> list[pathlib.Path]:
    args = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    return generate_plots(load_config(args.config, args.data_dir))


if __name__ == "__main__":
    main()
