"""The harness with the timed path broken underneath: the stand-in
program (the reference itself, tests/stub.py) with one fault planted per
run, and the cell's own limits.  Every fault comes out not correct; the
sound stand-in comes out correct.  The look for a chip is skipped: the
harness runs on the CPU at a size a test run holds."""

import pytest

import bench_cells as bc
import run
from stub import stub_factory

CELLS = ("pots_sweep", "full_level", "pots_stream")
FAULTS = ("state_unchanged", "half_lanes", "altered")


def _run(workload, fault, trace=0):
    run._environment()
    spec, cell, cfg, traffic = bc.tiny(workload)
    return run.bench(bc.args(trace=trace), spec, cell, cfg, traffic,
                     make_program=stub_factory(fault), device="cpu",
                     workers=0, log=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    result, rows = _run(workload, fault)
    assert result["correct"] is False, rows


@pytest.mark.parametrize("workload", CELLS)
def test_sound_stand_in_is_correct(workload):
    result, rows = _run(workload, None)
    assert result["correct"] is True, rows
