"""The harness end to end on the card: a short run of the cell
prints a correct result with its metrics.  Needs a CUDA card (it skips
without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

import bench_cells as bc


@pytest.mark.cuda
def test_short_run_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "full_level",
         "--seed", str(2 ** 31 + 7), "--seconds", "2", "--trace", "1"],
        cwd=bc.ROOT, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "kernel_roofline" in r["metrics"]
    assert 0 < r["metrics"]["kernel_roofline"]["value"] < 100
