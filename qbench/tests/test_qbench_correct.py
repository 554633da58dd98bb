"""``correct`` against each cell's limits (``qbench/limits/<cell>.json``):
true for the program, false for the control (the reference a precision
below the configuration's, in the program's place) and false for each
fault planted in the timed path. The look for a card is skipped: whole runs
on the CPU at tiny sizes, the program in float32 so that the sound run's
numbers are round-off, the faults and the control as the card's. The
serving cells, not yet in ``BENCHMARK.json``, are held to their provisional
limits."""

from __future__ import annotations

import pytest

from qbench import checks, harness
from qbench.calibrate import readings
from qbench.faults import FAULTS, planted

from tiny import shrink, staged_bench

BENCH = staged_bench()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
KIND = {name: harness.resolve(BENCH, name)[2]["loop"] for name in CELLS}


def shrink32(conf, mix):
    conf, mix = shrink(conf, mix)
    conf["model"]["compute_dtype"] = "float32"
    return conf, mix


def _run(cell: str, seed: int = 21) -> dict:
    return harness.run(cell, seed, 0.3, False, device="cpu", t_start=0.0, shrink=shrink32,
                       bench=BENCH)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS) for f in FAULTS[KIND[c]]])
def test_fault_is_not_correct(cell, fault):
    with planted(KIND[cell], fault):
        r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    nums = readings(cell, 22, "control", device="cpu", shrink=shrink, bench=BENCH)
    ok, judged = checks.judge(nums, checks.load_limits(cell))
    assert not ok, judged
