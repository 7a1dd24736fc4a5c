"""Tutorial 06: a surface reconstruction split over processes.

Counterpart of ``tutorials/06_multi_process_reconstruction.py``.
``setup_distributed_environment`` starts the process group, maps the heliostat
groups round-robin onto the ranks and builds the mesh; handed to an optimizer,
the setup makes each rank reconstruct its share, and the results merge, so every
rank ends with the whole field. One process (no arguments)::

    python -m artist_tpu_torch.tutorials.multi_process_reconstruction [--device cuda]

Two processes on this machine, over gloo on a free local port (``fork``), or one
rank of such a world started by hand (``worker RANK --port PORT``)::

    python -m artist_tpu_torch.tutorials.multi_process_reconstruction fork [--device cuda]

Each rank prints its line and a JSON line with its merged groups and final losses.
Under ``torchrun`` a rank needs neither (``setup_distributed_environment`` reads
the environment).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.scenario.synthetic import SyntheticCalibrationParser, make_synthetic_scenario, split_into_groups
from artist_tpu_torch.util import constants

GROUPS = 2
SURFACE_POINTS = (4, 4)
WORLD = 2
WORKER_TIMEOUT = 600.0  # seconds a forked rank may take


def tutorial_scenario(device: torch.device | str = "cuda") -> Scenario:
    """4 synthetic heliostats (6 x 6 control points, 4 x 4 points a facet, 4 rays a
    point) in :data:`GROUPS` groups."""
    return split_into_groups(
        make_synthetic_scenario(
            number_of_heliostats=4,
            number_of_control_points_per_facet=(6, 6),
            number_of_surface_points_per_facet=SURFACE_POINTS,
            number_of_rays=4,
            device=device,
        ),
        GROUPS,
    )


def optimization_configuration() -> dict:
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-4,
            constants.tolerance: 1e-9,
            constants.max_epoch: 3,
            constants.batch_size: 8,
            constants.log_step: 0,
            constants.early_stopping_delta: 1.0,
            constants.early_stopping_patience: 5,
            constants.early_stopping_window: 40,
        },
        constants.scheduler: {constants.scheduler_type: constants.exponential, constants.gamma: 0.99},
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.energy_tolerance: 0.01,
            constants.weight_smoothness: 0.005,
            constants.weight_ideal_surface: 0.005,
        },
    }


def reconstruct(scenario: Scenario, setup=None):
    """The tutorial's reconstruction of ``scenario`` (on its device) on the synthetic
    parser's samples, split as ``setup`` says (None: one process). Returns the final
    losses and the merged group results."""
    reconstructor = SurfaceReconstructor(
        scenario=scenario,
        data={constants.data_parser: SyntheticCalibrationParser(), constants.heliostat_data_mapping: []},
        optimization_configuration=optimization_configuration(),
        number_of_surface_points=SURFACE_POINTS,
        bitmap_resolution=(32, 32),
        distributed_setup=setup,
    )
    return reconstructor.reconstruct_surfaces("kl_divergence")


def run(
    coordinator: str | None = None, num_processes: int = 1, process_id: int = 0, device: torch.device | str = "cuda"
) -> dict:
    """One rank of a world of ``num_processes`` on gloo (``coordinator``: ``host:port``
    of rank 0's store; None for one process): the scenario, the split and the
    reconstruction. Returns the rank, the world size, the merged groups and the
    final loss of each heliostat."""
    with setup_distributed_environment(
        number_of_heliostat_groups=GROUPS,
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        device=str(device),
        backend="gloo",
    ) as setup:
        final_loss, results = reconstruct(tutorial_scenario(device), setup)
        return dict(
            rank=setup.rank,
            world_size=setup.world_size,
            groups=[result.group_index for result in results],
            final_loss=np.asarray(final_loss, np.float64).tolist(),
        )


def report(result: dict) -> None:
    print(
        f"rank {result['rank']}/{result['world_size']}: groups merged = {result['groups']}, "
        f"final loss per heliostat = {np.round(result['final_loss'], 4).tolist()}"
    )
    print(json.dumps(result), flush=True)


def free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def fork(device: str, timeout: float = WORKER_TIMEOUT) -> int:
    """Start :data:`WORLD` ranks of this module as processes on a free local port, wait
    for them (at most ``timeout`` seconds each; then kill the rest) and return the
    largest exit code."""
    port = free_port()
    root = str(pathlib.Path(__file__).resolve().parents[2])
    environment = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "worker", str(rank), "--port", str(port), "--device", device],
            env=environment,
        )
        for rank in range(WORLD)
    ]
    try:
        return max(worker.wait(timeout=timeout) for worker in workers)
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", nargs="?", choices=("fork", "worker"), help="fork two ranks, or run one of them")
    parser.add_argument("rank", nargs="?", type=int, default=0, help="this worker's rank")
    parser.add_argument("--port", type=int, help="rank 0's port on 127.0.0.1 (worker)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.mode == "fork":
        return fork(args.device)
    if args.mode == "worker":
        if args.port is None:
            parser.error("a worker needs --port")
        report(run(f"127.0.0.1:{args.port}", WORLD, args.rank, args.device))
    else:
        report(run(device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
