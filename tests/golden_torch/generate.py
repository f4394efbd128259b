#!/usr/bin/env python
"""Generate the main path's golden traces (tests/golden_torch/*.npz).

    python tests/golden_torch/generate.py [name ...]   # a subset by name

Each trace is a 50-digit run of ``acme_tpu_torch.utils.golden.golden_run``
(mpmath, sharing nothing with the port's runtimes but the frozen model
matrices and the element residuals) on the main path's model,
``sweeps.build_model("pots", "chain")``: the chain-decomposed Super Over
with drive and tone as inputs, the model of the headline workload of
``bench.py``.  The input rows are the audio, the bench's 0.2-amplitude
1 kHz sine at 44.1 kHz, and the lane's drive and tone, constant.

Lanes, of the 4096-lane drive x tone grid (``sweeps.lane_grid("pots",
4096)``), named here so that no run chooses them: 1000 (drive 0.264, tone
0.621: a control, where the fused main path reads about -98 dB against
the float64 engine), 2080 (0.507, 0.507), 3079 (0.736, 0.150: the worst
lane of that comparison over the whole grid), 3600 (0.850, 0.279) and
4000 (0.936, 0.507).

``lane<N>.npz``: T = 441 samples (ten periods) from the committed fused
seed of the lane (``.steadyseed_cache.npz``, tag
``seed2_pots_chain_fs44100_L4096``), the start of every runtime: x_init
and z_init are the seed's point in the model's coordinates, each the
float64 sum of the seed's float32 (hi, lo) pair, uncentred
(``golden.fused_point``).  The fused runner starts from the seed itself,
the engine and the host runtime from x_init and z_init.

``lane<N>_from<S>.npz`` (``RESUME``): a trace of the same lane that starts
at sample S of window 1, from the float64 scan engine's carry there (its
plain version on the CPU at tol 1e-12, run from the lane's seed point
over S samples), saved as x_init, z_init and the warm starts' p_init and
dzdp_init.  S is the sample where the fused main path's error against
the engine, both from the seed on the card over window 1, peaks
(``chip_smoke.py``'s golden phase prints it), for the lanes where it
peaks after sample 441.

Deterministic: fixed inputs, seeds and precision.  A trace's samples
depend only on the samples before them, so a prefix regenerated alone
equals the committed one bit for bit (tests/test_torch_golden_oracle.py
checks one).  The traces are written in worker processes, one per trace:
about 40 s for the five seeded ones; the resumed ones add the engine's
plain run up to their starts (one batch of their lanes to sample 23855,
about 19 min on one CPU core).
"""
import copy
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

from acme_tpu_torch import FusedRunner                       # noqa: E402
from acme_tpu_torch import sweeps as S                       # noqa: E402
from acme_tpu_torch.convert import load_steady_seed          # noqa: E402
from acme_tpu_torch.engine import compile_model              # noqa: E402
from acme_tpu_torch.models import superover_model             # noqa: E402
from acme_tpu_torch.utils.golden import (engine_start, fused_point,  # noqa
                                         golden_run)

HERE = os.path.dirname(os.path.abspath(__file__))
SEEDS = os.path.join(ROOT, ".steadyseed_cache.npz")
SEED_TAG = "seed2_pots_chain_fs44100_L4096"
FS = 44100
L_GRID = 4096
DPS = 50
T = 441
LANES = (1000, 2080, 3079, 3600, 4000)
# lane: the sample of window 1 where a resumed trace starts (where the
# fused main path's departure from the engine over window 1 peaks, both
# from the lane's seed point: ``chip_smoke.py --golden`` on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md's run AN), and the resumed traces' length
RESUME = {1000: 16710, 2080: 23855, 3079: 21032, 3600: 636, 4000: 1364}
RESUME_T = 441
ENGINE_TOL = 1e-12


def main_model(matrices=None):
    """The main path's model, ``sweeps.build_model("pots", "chain")``, from
    its exact matrices where given (the same model, bit for bit; the
    build changes them, so each build takes its own)."""
    return superover_model(matrices=matrices, **S.model_spec("pots", "chain",
                                                             FS))


def lane_input(lane, T, start=0):
    """(3, T): the bench's sine from sample ``start`` of window 1 (a slice
    of the whole window's), the lane's drive and tone."""
    _, drive, tone, _, _ = S.lane_grid("pots", L_GRID)
    audio = 0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(start + T))
    return np.vstack([audio[start:], np.full(T, drive[lane]),
                      np.full(T, tone[lane])])


def seed_points(model, lanes):
    """{lane: (x_init, z_init)}: each lane's committed fused seed in the
    model's coordinates."""
    fr = FusedRunner(copy.deepcopy(model), lane_input_idx=(1, 2),
                     device="cpu", **S.PRODUCTION)
    x, z = fused_point(fr, load_steady_seed(SEEDS, SEED_TAG, fr,
                                            lanes=list(lanes)))
    return {lane: (x[j], z[j]) for j, lane in enumerate(lanes)}


def seed_trace(model, lane, x_init, z_init, T=T):
    """The trace of ``lane`` over T samples from its seed point."""
    u = lane_input(lane, T)
    y = golden_run(copy.deepcopy(model), u, dps=DPS, x_init=x_init,
                   z_init=z_init)
    return dict(u=u, y=y, x_init=x_init, z_init=z_init, fs=FS, dps=DPS,
                lane=lane, start=0)


def engine_carries(model, points):
    """{lane: the engine's carry at sample RESUME[lane] of window 1}, run
    from the lane's seed point (one batch, chained up to each start):
    x_init, z_init, p_init and dzdp_init."""
    lanes = sorted(RESUME, key=RESUME.get)
    cm = compile_model(copy.deepcopy(model), tol=ENGINE_TOL, device="cpu")
    starts = [dict(x_init=points[n][0], z_init=points[n][1],
                   u=lane_input(n, 1)) for n in lanes]
    state, at, out = engine_start(cm, starts), 0, {}
    u = np.stack([lane_input(n, max(RESUME.values())) for n in lanes])
    for n in lanes:
        if RESUME[n] > at:
            _, state, _ = cm.run(u[:, :, at:RESUME[n]], state=state)
            at = RESUME[n]
        j = lanes.index(n)
        w = state["warms"]
        cat = lambda key: np.concatenate(
            [getattr(v, key)[j].numpy().reshape(-1) for v in w])
        out[n] = dict(x_init=state["x"][j].numpy(), z_init=cat("z"),
                      p_init=cat("p"), dzdp_init=cat("dzdp"))
    return out


def resumed_trace(model, lane, carry):
    start = RESUME[lane]
    u = lane_input(lane, RESUME_T, start)
    y = golden_run(copy.deepcopy(model), u, dps=DPS,
                   x_init=carry["x_init"], z_init=carry["z_init"])
    return dict(u=u, y=y, fs=FS, dps=DPS, lane=lane, start=start, **carry)


def names():
    return [f"lane{n}" for n in LANES] + [f"lane{n}_from{s}"
                                          for n, s in RESUME.items()]


def _write(job):
    """Write one trace (a worker's job): (name, lane, start data, the
    model's exact matrices)."""
    name, lane, data, mats = job
    t0 = time.time()
    model = main_model(mats)
    if isinstance(data, dict):
        tr = resumed_trace(model, lane, data)
    else:
        tr = seed_trace(model, lane, *data)
    np.savez_compressed(os.path.join(HERE, f"{name}.npz"), **tr)
    return (f"{name}: T={tr['u'].shape[1]} start={tr['start']} peak="
            f"{np.max(np.abs(tr['y'])):.4f} ({time.time() - t0:.1f}s)")


def main():
    only = set(sys.argv[1:])
    todo = [n for n in names() if not only or n in only]
    t0 = time.time()
    mats = S._matrices(S.model_spec("pots", "chain", FS))
    model = main_model(copy.deepcopy(mats))    # the build takes them over
    resume = any("_from" in n for n in todo)
    # the engine's carries come from one batch of every resumed lane
    lanes = sorted({int(n[4:].split("_")[0]) for n in todo}
                   | (set(RESUME) if resume else set()))
    points = seed_points(model, lanes)
    carries = engine_carries(model, points) if resume else {}
    print(f"model, seeds and engine carries: {time.time() - t0:.1f}s",
          flush=True)
    jobs = []
    for n in todo:
        lane = int(n[4:].split("_")[0])
        jobs.append((n, lane, carries[lane] if "_from" in n
                     else points[lane], mats))
    # a DiscreteModel does not pickle: each worker builds its own from the
    # exact matrices
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        for line in pool.imap(_write, jobs):
            print(line, flush=True)
    print(f"total {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
