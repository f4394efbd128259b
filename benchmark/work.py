"""The fixed work of one lane-sample, from a configuration's dimensions.

The least arithmetic that one Newton step per subsystem per sample needs,
whatever implements it (a DK-method model: nx states, nu inputs, ny
outputs, subsystems of nn unknowns, np and nq sizes):

* 2 FLOPs per multiply-add of the state update, the output row and each
  subsystem's p map (from x, u and the earlier subsystems' unknowns) and
  q map (from p and its own unknowns);
* one evaluation of each nonlinear element's current and derivative,
  ``ELEMENT_FLOPS`` (an exponential counts as one);
* one LU solve of each subsystem's nn x nn Jacobian, 2/3 nn^3 + 2 nn^2.

Bytes: each block's shared input read once, the lane values and the state
(x and the unknowns) read and written once, and y written once, in
float32.  A program that does more (more Newton steps, redone solves,
double-float verdicts) does not raise the count: the count is the yardstick
a share of the peak is taken against.
"""

from __future__ import annotations

import json
import os

__all__ = ["ELEMENT_FLOPS", "flops_per_lane_sample", "block_bytes",
           "peaks"]

ELEMENT_FLOPS = {"diode": 6, "bjt": 20, "potentiometer": 8}
WORD = 4


def flops_per_lane_sample(dims, elements):
    """FLOPs of one lane-sample for ``dims`` (nx, nu, ny, nn, np, nq) and
    ``elements`` ({kind: count} of the nonlinear elements)."""
    nx, nu, ny = dims["nx"], dims["nu"], dims["ny"]
    nn, np_, nq = dims["nn"], dims["np"], dims["nq"]
    n_all = sum(nn)
    macs = (nx + ny) * (nx + nu + n_all)
    before = 0
    for k in range(len(nn)):
        macs += np_[k] * (nx + nu + before) + nq[k] * (np_[k] + nn[k])
        before += nn[k]
    lu = sum(2.0 / 3.0 * n ** 3 + 2.0 * n ** 2 for n in nn)
    elem = sum(ELEMENT_FLOPS[k] * int(c) for k, c in elements.items())
    return 2.0 * macs + lu + elem


def block_bytes(dims, lanes, samples, lane_columns, time_rows):
    """Bytes one block of ``samples`` over ``lanes`` must move at least:
    ``time_rows`` shared input rows, ``lane_columns`` values per lane."""
    nx, ny = dims["nx"], dims["ny"]
    n_all = sum(dims["nn"])
    return WORD * (samples * time_rows + lanes * lane_columns
                   + 2 * lanes * (nx + n_all) + lanes * ny * samples)


def peaks(device_name):
    """The peak rates of ``device_name`` from ``peaks.json``:
    {"float32_flops": ..., "hbm_bytes_per_s": ...}; None for a card the
    table does not hold."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "peaks.json")
    with open(path) as f:
        table = json.load(f)
    for entry in table["devices"]:
        if entry["name"] == device_name:
            return entry
    return None
