"""The control on the card: the reference in the program's place, a precision lower (TF32 matrix
products for float32), comes out not correct. At the cells' own size the readings that the limits
were set from come from ``benchmark/limits.py``; this keeps the check at a size a test run holds
(``python -m pytest benchmark/tests -m card`` on a card)."""

from __future__ import annotations

import json

import pytest

from benchmark import check, limits

from conftest import TINY_SEED

CELLS = ("surface12.reconstruct", "field100.kinematics_raytracing", "field100.kinematics_alignment")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny_root, card, cell):
    workload = json.loads((tiny_root / "benchmark" / "workloads" / f"{cell}.json").read_text())
    rows = limits.readings(tiny_root, cell, [TINY_SEED], 1, card)
    control = next(row for row in rows if row["side"] == "control_tf32")
    assert not check.verdict(control, workload["check"]["limits"]), control
