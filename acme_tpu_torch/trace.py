"""The port's own tracing: host spans and the fused kernel's tier counters.

Tracing is on while a ``torch.profiler`` records, or inside
``recording()``, and at no other time.  While it is on:

* each stage of ``FusedRunner.run`` is a span (``acme.run``,
  ``acme.powerup``, ``acme.prepare_inputs``, ``acme.lane_tolerances``,
  ``acme.launch``, ``acme.check_outputs`` and its two ``acme.wait``): its
  name, start and end on the host clock (``time.perf_counter``, seconds)
  and its parent are recorded, and under a profiler the span is also a
  ``torch.profiler.record_function`` range, so that the profiler's events
  name the stage on the device trace's clock;
* every launch of the fused kernel that ``FusedRunner.run`` makes on the
  card gets the recorder's stats buffer for its runner's build and lane
  count (a mesh entry's for its lanes), (counters, nsub, L) int64, to
  which the kernel adds, on the device and with no sync, each lane's
  cycles by solver tier and the events of its solver ladder
  (``COUNTERS``, the rows of ``ops/csrc/step.cuh``'s ``Stat``).
  ``FusedInfo.tiers`` is that buffer: the sums over every traced call so
  far, the call's own included.

While it is off a span costs one boolean check, the launch gets a null
stats pointer and runs the untraced step (each build holds both), and
``FusedInfo.tiers`` is None.  The plain version (a
runner on the CPU) records spans and counts no tiers.  The records stay in
memory until ``clear()``:

    from acme_tpu_torch import trace
    with trace.recording():
        y, state, info = runner.run(u_time, lane_values, state=state)
    print(trace.snapshot())    # spans by name, tier shares, counts

``records()`` and ``counters()`` hand out the raw records, and
``per_run()`` the spans by top-level call, for readers that compute their
own numbers from them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch

__all__ = ["COUNTERS", "TIERS", "Span", "on", "recording", "span", "spanned",
           "tier_buffer", "records", "counters", "per_run", "snapshot",
           "clear"]

# the rows of a stats buffer (ops/csrc/step.cuh Stat, in its order): the
# cycles of the solver tiers, the lane's whole launch (subsystem 0's
# column), then the counts: subsystem solves, redos (the keep test
# failed), homotopy entries, df rescues, fold passes and the evaluations of
# the fast, polish and redo tiers (together what the launch adds to iters)
COUNTERS = ("warm", "fast", "polish", "redo", "commit", "total", "solves",
            "redos", "homotopy", "df_rescues", "fold_passes", "ev_fast",
            "ev_polish", "ev_redo")
TIERS = COUNTERS[:5]

_profiling = torch.autograd._profiler_enabled
_depth = 0          # open recording() contexts
_spans = []         # [name, start, end, the parent's record or None]
_open = []          # the records of the spans not yet closed, innermost last
_tiers = {}         # (id(plan), L, device, lane0) -> (plan, stats buffer)


class Span(NamedTuple):
    """One recorded span: host-clock seconds, ``end`` None while open,
    ``parent`` the index of the enclosing span in ``records()`` or -1."""
    name: str
    start: float
    end: float
    parent: int


def on():
    """Whether tracing is on: a ``torch.profiler`` records, or a
    ``recording()`` context is open."""
    return _depth > 0 or _profiling()


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, with or without a profiler."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


class _Open:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rec = [self.name, time.perf_counter(), None,
                    _open[-1] if _open else None]
        _spans.append(self.rec)
        _open.append(self.rec)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec[2] = time.perf_counter()
        _open.pop()       # spans close innermost first
        return False


_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that records the stage ``name`` while tracing is
    on, and does nothing otherwise."""
    return _Open(name) if on() else _OFF


def spanned(name):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not on():
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def tier_buffer(plan, L, device, lane0=0):
    """The recorder's stats buffer for launches of ``plan`` over L lanes on
    ``device`` (a mesh entry's: from lane ``lane0`` of the run), zeros when
    first asked for, to which each launch adds its counters; None while
    tracing is off."""
    if not on():
        return None
    key = (id(plan), L, str(torch.device(device)), lane0)
    if key not in _tiers:
        _tiers[key] = (plan, torch.zeros(
            (len(COUNTERS), max(plan.nsub, 1), L), dtype=torch.int64,
            device=device))
    return _tiers[key][1]


def records():
    """Every span recorded so far, in the order they were opened."""
    index = {id(r): i for i, r in enumerate(_spans)}
    return [Span(n, a, b, -1 if p is None else index.get(id(p), -1))
            for n, a, b, p in _spans]


def counters(by_build=False):
    """The stats buffers' sums over lanes and subsystems, by counter name
    ({} before any buffer was handed out); with ``by_build`` one such dict
    per "<build>/<lanes>" (the library's file name, else the plan's
    kernel name).  Reading them waits for the card."""
    out = {}
    for (_, L, _, _), (plan, t) in _tiers.items():
        row = out.setdefault(f"{plan.cuda_name or plan.kernel_name}/{L}",
                             dict.fromkeys(COUNTERS, 0))
        for k, v in zip(COUNTERS, t.sum(dim=(1, 2)).tolist()):
            row[k] += int(v)
    if by_build:
        return out
    total = {}
    for row in out.values():
        for k, v in row.items():
            total[k] = total.get(k, 0) + v
    return total


def per_run():
    """The spans by top-level call: each closed ``acme.run`` span that no
    other encloses, and the closed spans inside it.  Returns {"runs": the
    calls} and, with one or more, their mean ms ("run_ms"), their mean
    host ms less their ``acme.wait`` spans' ("host_self_ms") and per span
    name its ms per call ("span_ms")."""
    recs = records()
    top = [-1] * len(recs)
    for i, r in enumerate(recs):
        if r.parent >= 0 and top[r.parent] >= 0:
            top[i] = top[r.parent]
        elif r.name == "acme.run":
            top[i] = i
    runs = {i for i, r in enumerate(recs) if top[i] == i and r.end is not None}
    if not runs:
        return {"runs": 0}
    span_ms = {}
    for i, r in enumerate(recs):
        if top[i] in runs and i != top[i] and r.end is not None:
            span_ms[r.name] = span_ms.get(r.name, 0.0) \
                + (r.end - r.start) * 1e3 / len(runs)
    run_ms = sum(recs[i].end - recs[i].start for i in runs) * 1e3 / len(runs)
    return {"runs": len(runs), "run_ms": run_ms,
            "host_self_ms": run_ms - span_ms.get("acme.wait", 0.0),
            "span_ms": span_ms}


def snapshot():
    """What the recorder holds, summed: per span name its count, total and
    mean ms; per top-level ``acme.run`` its mean ms and its mean host ms
    (less its ``acme.wait`` spans: ``per_run``); per build and lane count
    the counters and each tier's share of the lanes' launch cycles
    (``remainder``: the rest, the carry's loads and stores and the
    samples' outputs)."""
    recs = records()
    spans = {}
    for r in recs:
        if r.end is None:
            continue
        s = spans.setdefault(r.name, {"count": 0, "total_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += (r.end - r.start) * 1e3
    for s in spans.values():
        s["mean_ms"] = s["total_ms"] / s["count"]
    calls = per_run()
    out = {"spans": spans, "runs": calls["runs"]}
    if calls["runs"]:
        out["run_ms"] = calls["run_ms"]
        out["host_self_ms"] = calls["host_self_ms"]
    kernels = {}
    for build, c in counters(by_build=True).items():
        shares = {}
        if c["total"] > 0:
            shares = {t: 100.0 * c[t] / c["total"] for t in TIERS}
            shares["remainder"] = 100.0 - sum(shares.values())
        kernels[build] = {"counters": c, "tier_shares_pct": shares}
    out["kernels"] = kernels
    return out


def clear():
    """Forget every record, those of spans still open too."""
    _spans.clear()
    _tiers.clear()
