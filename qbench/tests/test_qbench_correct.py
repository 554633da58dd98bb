"""``correct`` against each cell's limits (``qbench/limits/<cell>.json``):
true for the program, false for the control (the reference a precision
below the configuration's, in the program's place) and false for each
fault planted in the timed path. The look for a card is skipped: whole runs
on the CPU at tiny sizes, the program in float32 so that the sound run's
numbers are round-off, the faults and the control as the card's. The
serving cells, not yet in ``BENCHMARK.json``, are held to their provisional
limits."""

from __future__ import annotations

import math

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


def _in_blocks(rows):
    def shrink_blocked(conf, mix):
        conf, mix = shrink(conf, mix)
        conf["check"] = {"rows_per_block": rows}
        return conf, mix
    return shrink_blocked


def test_check_in_blocks_of_rows_reads_as_the_whole_batch(monkeypatch):
    """``"check": {"rows_per_block": 1}`` in a configuration: the reference
    runs each compared batch a row at a time, in the check and in the fp8
    control alike, and the numbers compared are those of the whole batch in
    one pass, to float32 summation order. The control scales its fp8
    operands per block (a finer scale than per tensor): it still fails. A
    zero or non-integer block stops the run before set-up, naming the
    key."""
    import qbench.reference.train as ref_train

    rows = []
    forward = ref_train.forward

    def counted(params, model, x, *args, **kwargs):
        rows.append(x.shape[0])
        return forward(params, model, x, *args, **kwargs)

    monkeypatch.setattr(ref_train, "forward", counted)
    cell = "timit_qcnn.train"
    whole, blocked = {}, {}
    for out, rpb in ((whole, None), (blocked, 1)):
        rows.clear()
        out["run"] = harness.run(cell, 23, 0.3, False, device="cpu", t_start=0.0,
                                 shrink=_in_blocks(rpb) if rpb else shrink, bench=BENCH)
        out["run_rows"] = list(rows)
        rows.clear()
        out["control"] = readings(cell, 24, "control", device="cpu",
                                  shrink=_in_blocks(rpb) if rpb else shrink, bench=BENCH)
        out["control_rows"] = list(rows)
    assert max(whole["run_rows"]) > 1 and max(whole["control_rows"]) > 1
    for kind in ("run_rows", "control_rows"):
        assert set(blocked[kind]) == {1}
        assert len(blocked[kind]) == sum(whole[kind])
    got = {k: c["value"] for k, c in blocked["run"]["checks"].items()}
    want = {k: c["value"] for k, c in whole["run"]["checks"].items()}
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-3, abs_tol=1e-6), (k, got[k], want[k])
    assert blocked["run"]["correct"] == whole["run"]["correct"]
    ok, judged = checks.judge(blocked["control"], checks.load_limits(cell))
    assert not ok, judged
    for bad in (0, -2, 2.5, "8", True):
        with pytest.raises(ValueError, match="check.rows_per_block"):
            harness.run(cell, 23, 0.3, False, device="cpu", t_start=0.0,
                        shrink=_in_blocks(bad), bench=BENCH)
