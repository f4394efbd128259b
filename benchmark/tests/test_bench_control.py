"""The check's control, at a size a test run holds: the reference in
bfloat16 (check.CONTROL) put in the program's place fails each cell's
limits, and the float64 reference put there passes them.  On the chip,
``benchmark/control.py`` reads the same control at each cell's own size."""

import numpy as np
import pytest

import bench_cells as bc
import check
import gen

CELLS = ("pots_sweep", "full_level", "pots_stream")


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails(workload):
    spec, cell, cfg, traffic = bc.load(workload)
    seed = 2 ** 31 + 99
    lanes = gen.check_lanes(gen.lane_values(traffic["lanes"], seed).shape[0],
                            8, seed)
    n_warm = traffic["warmup"]["powerup_block"] \
        + traffic["block"] * traffic["warmup"]["blocks"]
    n = n_warm + 1024
    ref = check.reference_outputs(cfg, traffic, seed, lanes, n, workers=0)
    ctl = check.reference_outputs(cfg, traffic, seed, lanes, n, workers=0,
                                  kw=check.CONTROL)
    limits = traffic["check"]["limits"]
    numbers = dict(check.compare(ctl, ref, n_warm), raised=0)
    assert not check.verdict(numbers, limits)[0], numbers
    # the reference in the program's place, stored as float32 as the
    # program's outputs are, passes
    numbers = dict(check.compare(ref.astype(np.float32), ref, n_warm),
                   raised=0)
    assert check.verdict(numbers, limits)[0], numbers
