"""The plain reference against the port's float64 host runtime (the
ACME semantics, its Newton tolerance tightened), on both configurations'
circuits from cold: the two agree far below anything the check compares.
This test imports the port; the reference itself does not."""

import copy

import numpy as np
import pytest

import bench_cells as bc
from reference import Reference


# the host's residual tolerance: as tight as its Newton loop still meets
# on each circuit (1e-16 never ends on the pots model's subsystems)
@pytest.mark.parametrize("workload,lanes,tol", [
    ("pots_sweep", [[0.1, 0.2], [0.5, 0.5], [0.9, 0.95]], 1e-13),
    ("full_level", [[0.1], [1.0], [2.0]], 1e-16)])
def test_reference_matches_host_runtime(workload, lanes, tol):
    import acme_tpu_torch as A
    from acme_tpu_torch.models import superover_model
    cfg = bc.load(workload)[2]
    m = superover_model(**cfg["model"], fs=cfg["fs"])
    T = 300
    t = np.arange(T) / cfg["fs"]
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) * np.minimum(1.0, t * 100)
    lanes = np.array(lanes)
    r = cfg["runner"]
    ys = []
    for lv in lanes:
        mm = copy.deepcopy(m)
        for s in mm.solvers:
            s.set_resabstol(tol)
        if r.get("lane_input_idx"):
            u = np.concatenate([audio[None], np.repeat(lv[:, None], T, 1)])
        else:
            u = (audio * lv[0])[None]
        ys.append(A.run(mm, u))
    y_host = np.stack(ys)
    ref = Reference(cfg["netlist"], cfg["fs"], lanes,
                    lane_input_idx=r.get("lane_input_idx", ()),
                    lane_scale_idx=r.get("lane_scale_idx", ()))
    y = ref.run(audio[None])
    err = np.abs(y - y_host).max(axis=(1, 2))
    peak = np.abs(y_host).max(axis=(1, 2))
    assert np.all(err <= 1e-6 * peak), err / peak
