"""Every configuration and traffic file parses, and BENCHMARK.json keeps
the contract's forms: names and units of the allowed characters, every
cell's files and every metric's reader present."""

import os
import re

import pytest

import bench_cells as bc

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = bc.read_json(os.path.join(bc.ROOT, "BENCHMARK.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(bc.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"])
    assert _line(conf["why"]) and conf["reduced"] == []
    assert conf["file"].startswith("benchmark/configs/")
    cfg = bc.read_json(os.path.join(bc.ROOT, conf["file"]))
    assert cfg["name"] == conf["name"] and cfg["reduced"] == []
    assert cfg["source"] == conf["source"]
    for key in ("model", "runner", "dims", "netlist", "fs", "assumed",
                "nonlinear_elements"):
        assert key in cfg
    assert cfg["runner"]["powerup"] == "safe"
    assert any(e["kind"] == "voltageprobe" for e in cfg["netlist"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = bc.read_json(os.path.join(bc.BENCH, "traffic",
                                        cell["traffic"] + ".json"))
    for key in ("lanes", "block", "warmup", "stream", "check"):
        assert key in traffic
    limits = traffic["check"]["limits"]
    assert set(limits) == {"window_err_db", "warmup_err_db", "raised"}
    assert limits["raised"] == 0
    assert traffic["check"]["lanes"] >= 8


def _metrics():
    return [("end_to_end", m) for m in SPEC["end_to_end"]] + \
        [("per_layer", m) for m in SPEC["per_layer"]]


@pytest.mark.parametrize("kind,m", _metrics(), ids=lambda x: x
                         if isinstance(x, str) else x["name"])
def test_metric(kind, m):
    cells = {c["name"] for c in SPEC["workloads"]}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(bc.BENCH, "metrics",
                                       m["name"] + ".py"))
    assert set(m.get("workloads", cells)) <= cells
    if kind == "end_to_end":
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
        # the metric it moves is reported in each of its cells
        assert set(m.get("workloads", cells)) <= \
            set(moved.get("workloads", cells))


def test_every_cell_reports_enough():
    for c in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if c["name"] in m.get("workloads", [c["name"]])]
        pl = [m for m in SPEC["per_layer"]
              if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and pl


def test_paths_hold_only_name_characters():
    for dirpath, dirs, files in os.walk(bc.BENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".build")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), bc.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
