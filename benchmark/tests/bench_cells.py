"""Shared by the benchmark's CPU tests: the benchmark's folder on the
import path, and tiny copies of a cell (few lanes, short blocks) for the
harness to run on the CPU with the stub program."""

import copy
import json
import os
import sys
from types import SimpleNamespace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


# cells whose files are kept for a later benchmark entry, not listed in
# BENCHMARK.json: their configuration and traffic files are tested alike
UNLISTED = {"pots_sweep": ("superover_chain_pots", "pots_sweep"),
            "pots_stream": ("superover_chain_pots", "pots_stream")}


def load(workload):
    """(spec, cell, cfg, traffic) of a cell of BENCHMARK.json or of
    ``UNLISTED``."""
    import run
    if workload not in UNLISTED:
        return run.load_cell(workload, ROOT)
    config, traffic = UNLISTED[workload]
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {"name": workload, "config": config, "traffic": traffic,
            "chips": 1}
    return (spec, cell,
            read_json(os.path.join(BENCH, "configs", config + ".json")),
            read_json(os.path.join(BENCH, "traffic", traffic + ".json")))


def tiny(workload, lanes_per_axis=4, block=64, powerup=128, check_lanes=4):
    """(spec, cell, cfg, traffic) of ``workload`` cut to a size the plain
    reference runs in well under a second a block."""
    spec, cell, cfg, traffic = load(workload)
    cfg = copy.deepcopy(cfg)
    traffic = copy.deepcopy(traffic)
    cfg["runner"]["powerup_samples"] = powerup
    traffic["warmup"]["powerup_block"] = powerup
    traffic["block"] = block
    traffic["lanes"]["axes"] = [[lo, hi, min(n, lanes_per_axis)]
                                for lo, hi, n in traffic["lanes"]["axes"]]
    traffic["check"]["lanes"] = check_lanes
    return spec, cell, cfg, traffic


def args(seed=12345, seconds=0.3, trace=0):
    return SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


def read_json(path):
    with open(path) as f:
        return json.load(f)
