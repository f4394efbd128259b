"""The readers of the port's own tracing (``acme_tpu_torch.trace``):
``redo_share``, ``redo_cycle_share``, ``polish_cycle_share``,
``tolerances_ms`` and ``host_self_ms``.  Against a recorder filled by
hand, each returns the number its docstring defines; against the port's
recorder, the numbers of its snapshot; with the stand-in program, or
without the port loaded, nothing."""

import json
import sys
from types import SimpleNamespace

import pytest

import bench_cells as bc
import run
from stub import stub_factory

READERS = ("redo_share", "redo_cycle_share", "polish_cycle_share",
           "tolerances_ms", "host_self_ms")
Span = SimpleNamespace


def _span(name, start, end, parent):
    return Span(name=name, start=start, end=end, parent=parent)


# two calls of 1.0 s and 0.5 s: the first with 10 ms of tolerances and
# 0.9 s of waits, the second cold (a power-up split: its own inner calls,
# 4 + 6 ms of tolerances) with 0.45 s of waits; a span outside any call;
# and a call still open, which no reader counts
SPANS = [
    _span("acme.run", 0.0, 1.0, -1),
    _span("acme.prepare_inputs", 0.0, 0.012, 0),
    _span("acme.lane_tolerances", 0.001, 0.011, 1),
    _span("acme.launch", 0.012, 0.013, 0),
    _span("acme.check_outputs", 0.013, 0.95, 0),
    _span("acme.wait", 0.013, 0.813, 4),
    _span("acme.wait", 0.85, 0.95, 4),
    _span("acme.run", 2.0, 2.5, -1),
    _span("acme.powerup", 2.0, 2.5, 7),
    _span("acme.run", 2.0, 2.1, 8),
    _span("acme.lane_tolerances", 2.0, 2.004, 9),
    _span("acme.run", 2.1, 2.45, 8),
    _span("acme.lane_tolerances", 2.1, 2.106, 11),
    _span("acme.check_outputs", 2.45, 2.5, 8),
    _span("acme.wait", 2.0, 2.45, 13),
    _span("acme.lane_tolerances", 3.0, 3.5, -1),
    _span("acme.run", 4.0, None, -1),
    _span("acme.lane_tolerances", 4.0, 4.5, 16),
]
COUNTS = {"warm": 50, "fast": 100, "polish": 500, "redo": 250,
          "commit": 40, "total": 1000, "solves": 400, "redos": 30}
WANT = {"redo_share": 7.5, "redo_cycle_share": 25.0,
        "polish_cycle_share": 50.0,
        "tolerances_ms": (10.0 + 4.0 + 6.0) / 2,
        "host_self_ms": ((1000.0 - 900.0) + (500.0 - 450.0)) / 2}


@pytest.fixture
def by_hand(monkeypatch):
    """The port's recorder filled by hand: its own walk over SPANS."""
    pytest.importorskip("torch")
    from acme_tpu_torch import trace
    monkeypatch.setattr(trace, "records", lambda: list(SPANS))
    rec = SimpleNamespace(per_run=trace.per_run,
                          counters=lambda: dict(COUNTS))
    monkeypatch.setitem(sys.modules, "acme_tpu_torch.trace", rec)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_recorder_filled_by_hand(by_hand, name):
    assert run.load_reader(name)(run.Run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_port(monkeypatch, name):
    monkeypatch.delitem(sys.modules, "acme_tpu_torch.trace", raising=False)
    assert run.load_reader(name)(run.Run()) is None


def test_readers_on_the_ports_recorder():
    """Spans and tier buffers recorded by the port's own recorder: the
    readers agree with its snapshot."""
    pytest.importorskip("torch")
    from acme_tpu_torch import trace
    trace.clear()
    for name in READERS:
        assert run.load_reader(name)(run.Run()) is None
    with trace.recording():
        for _ in range(3):
            with trace.span("acme.run"):
                with trace.span("acme.lane_tolerances"):
                    sum(range(20000))
                with trace.span("acme.wait"):
                    sum(range(20000))
        plan = SimpleNamespace(cuda_name="lib.so", kernel_name="fused_sweep",
                               nsub=1)
        stats = trace.tier_buffer(plan, 8, "cpu")
    for k, v in COUNTS.items():
        stats[trace.COUNTERS.index(k), 0, 0] = v
    snap = trace.snapshot()
    got = {n: run.load_reader(n)(run.Run()) for n in READERS}
    trace.clear()
    assert got["tolerances_ms"] == pytest.approx(
        snap["spans"]["acme.lane_tolerances"]["total_ms"] / 3)
    assert got["host_self_ms"] == pytest.approx(snap["host_self_ms"])
    shares = snap["kernels"]["lib.so/8"]["tier_shares_pct"]
    assert got["redo_cycle_share"] == pytest.approx(shares["redo"])
    assert got["polish_cycle_share"] == pytest.approx(shares["polish"])
    assert got["redo_share"] == pytest.approx(WANT["redo_share"])


def test_stub_program_reports_none_of_them():
    """A traced run of the stand-in program (the port loaded, its recorder
    empty): the line leaves the five metrics out."""
    pytest.importorskip("torch")
    from acme_tpu_torch import trace
    trace.clear()
    run._environment()
    spec, cell, cfg, traffic = bc.tiny("full_level")
    result, _ = run.bench(bc.args(trace=1), spec, cell, cfg, traffic,
                          make_program=stub_factory(), device="cpu",
                          workers=0, log=lambda *a: None)
    result = json.loads(json.dumps(result))
    wanted = {m["name"] for m in run.cell_metrics(spec, cell, 1)}
    assert set(READERS) <= wanted
    assert not set(READERS) & set(result["metrics"])
