#!/usr/bin/env python3
"""The control of a cell's check: the reference computed in bfloat16
(``check.CONTROL``) put in the program's place, judged as a run's outputs
are, on the cell's own lanes and samples.

    python3 benchmark/control.py --workload full_level --blocks 21 \
        --seeds 11 12 13

``--blocks``: the window's blocks, as many as a run of the cell completes
in ``run_seconds`` (its warm-up comes before them).  Prints one JSON line
per seed with the numbers compared and whether they pass the cell's
limits: a sound check reads ``"correct": false`` on every seed.  The
harness's runs never run this.
"""

import argparse
import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import check  # noqa: E402
import gen  # noqa: E402
from run import load_cell  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    spec, cell, cfg, traffic = load_cell(args.workload)
    T = int(traffic["block"])
    n_warm = int(traffic["warmup"]["powerup_block"]) \
        + T * int(traffic["warmup"]["blocks"])
    n = n_warm + T * args.blocks
    jobs, keys = [], []
    for seed in args.seeds:
        L = gen.lane_values(traffic["lanes"], seed).shape[0]
        chk = gen.check_lanes(L, int(traffic["check"]["lanes"]), seed)
        vals = gen.lane_values(traffic["lanes"], seed)[chk]
        for i in range(0, len(vals), check.LANES_PER_WORKER):
            part = vals[i:i + check.LANES_PER_WORKER]
            for kind, kw in (("reference", None), ("control", check.CONTROL)):
                jobs.append((cfg, traffic["stream"], seed, part, n, kw))
                keys.append((seed, kind))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(args.workers, mp_context=ctx) as ex:
        outs = list(ex.map(check._worker, jobs))
    import numpy as np
    for seed in args.seeds:
        ref = np.concatenate([o for o, k in zip(outs, keys)
                              if k == (seed, "reference")])
        ctl = np.concatenate([o for o, k in zip(outs, keys)
                              if k == (seed, "control")])
        numbers = check.compare(ctl, ref, n_warm)
        numbers["raised"] = 0
        ok, rows = check.verdict(numbers, traffic["check"]["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "samples": n, "lanes": int(ref.shape[0]),
                          "correct": ok,
                          "check": {r[0]: r[1] for r in rows}}), flush=True)


if __name__ == "__main__":
    main()
