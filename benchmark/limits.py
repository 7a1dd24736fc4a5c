"""Readings that the limits of a cell's check are set from, on the card at the cell's own size.

    python3 benchmark/limits.py --workload <cell> --first-seed <n> --seeds 12 --faulty 12

For each of ``--seeds`` seeds, in one process: the traffic, the port's first steps
through its public entry (as a run's set-up takes them) and the reference's, compared
as a run compares them (the lower readings). For the first ``--faulty`` seeds also
the reference put in the program's place with TF32 on (the control: the nearest
precision below float32) and with each fault that the workload file lists planted
(:mod:`benchmark.reference.steps`: ``half_batch``, ``altered_answer``, ``shifted_answers``),
each compared with the plain reference (the upper readings). A parameter state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run. Prints one JSON line a reading and a summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import check, run  # noqa: E402
from benchmark.field import field_arrays  # noqa: E402


def reference_readings(job, inputs: dict, steps: int, block: int, device, tf32: bool = False, fault=None):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return job.reference_steps(dict(inputs, fault=fault), steps, block, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def readings(root: pathlib.Path, name: str, seeds: list[int], faulty: int, device) -> list[dict]:
    _, _, workload, config = run.cell(root, name)
    job = run.job_module(root, config["job"])
    steps, block = int(workload["check"]["steps"]), int(workload["check"]["block"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = field_arrays(config["field"])
    rows = []
    for index, seed in enumerate(seeds):
        started = time.perf_counter()
        data = job.make_traffic(arrays, workload["traffic_parameters"], seed, device)
        entry = job.build(config, workload, arrays, data, seed, device)
        program = run.first_steps(entry, steps)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
        inputs = job.reference_inputs(config, workload, arrays, data, seed, device)
        reference = reference_readings(job, inputs, steps, block, device)
        rows.append(dict(seed=seed, side="program", **check.compare(program, reference),
                         seconds=time.perf_counter() - started))
        print(json.dumps(rows[-1]), flush=True)
        if index < faulty:
            sides = [("control_tf32", dict(tf32=True))] + [(fault, dict(fault=fault)) for fault in workload["faults"]]
            for side, options in sides:
                faulty_reading = reference_readings(job, inputs, steps, block, device, **options)
                rows.append(dict(seed=seed, side=side, **check.compare(faulty_reading, reference)))
                print(json.dumps(rows[-1]), flush=True)
        del inputs, data
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def summary(rows: list[dict]) -> dict:
    """Per side, the largest (program) or the smallest (control, faults) reading of each number."""
    out = {}
    for side in sorted({row["side"] for row in rows}):
        chosen = [row for row in rows if row["side"] == side]
        pick = max if side == "program" else min
        out[side] = {key: pick(row[key] for row in chosen) for key in check.NUMBERS}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--first-seed", type=int, default=2_200_000_000)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--faulty", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("limits: no CUDA card", file=sys.stderr)
        return 2
    from artist_tpu_torch.kernels.build import build_all

    build_all()
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    rows = readings(run.ROOT, args.workload, seeds, args.faulty, torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
