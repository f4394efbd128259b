"""The result line's form, on the stand-in program: its keys, in order,
the metrics of the cell for each kind of run, the device, the breakdown
of a traced run, and each number compared beside its limit, last.  And a
run without a card exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_cells as bc
import run
from stub import stub_factory


def _result(workload, trace):
    run._environment()
    spec, cell, cfg, traffic = bc.tiny(workload)
    result, rows = run.bench(bc.args(trace=trace), spec, cell, cfg, traffic,
                             make_program=stub_factory(), device="cpu",
                             workers=0, log=lambda *a: None)
    return spec, cell, json.loads(json.dumps(result))


@pytest.mark.parametrize("workload", ["full_level"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    spec, cell, r = _result(workload, trace)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "check"
    assert isinstance(r["correct"], bool) and r["attempted"] > 0
    want = {m["name"]: m["unit"] for m in run.cell_metrics(spec, cell, trace)}
    got = {k: v["unit"] for k, v in r["metrics"].items()}
    if trace:
        # the stand-in launches no kernel: the kernel's readers find
        # nothing to read and are left out
        assert set(got) <= set(want) and "evals_per_lane_sample" in got
        assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
    else:
        assert got == want
    for v in r["metrics"].values():
        assert isinstance(v["value"], float)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for name, v in r["check"].items():
        assert set(v) == {"value", "limit"}


def test_nonfinite_output_counts_as_failed():
    """A non-finite output sample in each of the window's calls counts in
    ``failed``, and the run is not correct."""
    run._environment()
    spec, cell, cfg, traffic = bc.tiny("full_level")
    r, rows = run.bench(bc.args(), spec, cell, cfg, traffic,
                        make_program=stub_factory("nonfinite"), device="cpu",
                        workers=0, log=lambda *a: None)
    blocks = r["attempted"] // (4 * traffic["block"])
    assert blocks >= 1 and r["failed"] == blocks
    assert r["correct"] is False, rows


def test_no_card_no_result(tmp_path):
    """Without a card (this CPU machine), and in a directory that holds
    only BENCHMARK.json and the benchmark's files, the run exits non-zero
    and prints nothing on standard output."""
    root = tmp_path / "checkout"
    shutil.copytree(bc.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".build"))
    shutil.copy(os.path.join(bc.ROOT, "BENCHMARK.json"), root)
    for cwd in (bc.ROOT, root):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "full_level",
             "--seed", "5", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == ""
