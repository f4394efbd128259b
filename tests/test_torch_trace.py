"""The port's own tracing (``acme_tpu_torch.trace``), on the CPU.

The fused kernel's tier counters, in its host build (the g++ build of
``ops/csrc``, whose clock reads 0, so it counts every event the card counts
and no cycles): with the stats buffer set, y, state, fails, iters and
floored are bit for bit as with it unset; the evaluations of the fast,
polish and redo tiers sum to iters for every lane and subsystem; the redos
are at most the solves, which are samples x nsub.  The builds: the clipper
with input levels that take the redo, the main path from its seeds with a
lane that takes the rescue ladder, the full path's power-up sibling (the
robust path every sample) and production build (the fold loop), a build
that couples lane groups, and a model without subsystems.

The recorder: spans nest and record their parents; with tracing off
nothing is recorded; ``trace.recording()`` and an active
``torch.profiler`` each turn it on; its sums and snapshot.  Skipped where
g++ is absent (the host builds only).
"""

import copy
import os
import re
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from acme_tpu_torch import FusedRunner, trace
from acme_tpu_torch import models as M
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.convert import load_steady_seed
from acme_tpu_torch.ops import fused as F
from acme_tpu_torch.ops.build import CSRC, load_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROD = S.PRODUCTION
C = {k: i for i, k in enumerate(trace.COUNTERS)}


@pytest.fixture(autouse=True)
def _empty_recorder():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return str(tmp_path_factory.mktemp("acme_trace_build"))


@pytest.fixture(scope="module")
def full_model():
    return S.build_model("level", "full")


def _sine(amp, T):
    return (amp * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]


def _case(name, request, out):
    """(runner, its step's arguments, samples) of a host-build case."""
    if name in ("clipper", "group"):
        kw = dict(PROD, fast_verify="group", group_lanes=128) \
            if name == "group" else PROD
        fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,), **kw,
                         device="cpu")
        rng = np.random.default_rng(5)
        lv = np.concatenate([rng.uniform(0.01, 3.0, 128),
                             rng.uniform(0.01, 0.05, 128)])[:, None]
        ut, st = _sine(1.5, 48), fr.initial_state(256)
    elif name == "main_redo":
        fr = FusedRunner(M.superover_model(drive=None, tone=None, level=1.0,
                                           vb_source=True),
                         lane_input_idx=(1, 2), powerup="steady", **PROD,
                         device="cpu")
        lanes = np.arange(1000, 1008)
        lv = S.lane_grid("pots", 4096)[3][lanes]
        st = load_steady_seed(os.path.join(ROOT, ".steadyseed_cache.npz"),
                              "seed2_pots_chain_fs44100_L4096", fr,
                              lanes=lanes)
        st["zw"][:, 3] *= 0.9
        st["dzdp"][:, 3] = 0.0
        ut = _sine(0.2, 4)
    elif name.startswith("full"):
        fr = FusedRunner(copy.deepcopy(request.getfixturevalue("full_model")),
                         lane_scale_idx=(0,), powerup="safe", **PROD,
                         device="cpu")
        pr = fr._powerup_runner()
        lv = np.linspace(0.1, 2.0, 16)[:, None]
        st = pr.initial_state(16)
        if name == "full":
            u, lvt, tol, gate = pr.prepare_inputs(_sine(0.2, 8), lv)
            st = F.host_step(load_host(pr.plan, out), pr.plan, u, lvt, tol,
                             gate, st, pr._coef_tables(16))[1]
        else:
            fr = pr
        ut = _sine(0.2, 8)
    else:
        fr = FusedRunner(M.sallenkey_model(), **PROD, device="cpu")
        lv, ut, st = np.zeros((128, 0)), _sine(0.5, 16), fr.initial_state(128)
    u, lvt, tol, gate = fr.prepare_inputs(ut, lv)
    L = lvt.shape[1]
    return fr, (fr.plan, u, lvt, tol, gate, st, fr._coef_tables(L),
                fr._group(L)), ut.shape[1]


CASES = ["clipper", "main_redo", "full_powerup", "full", "group", "linear"]


@pytest.mark.parametrize("name", CASES)
def test_host_build_counts_without_changing_the_step(request, out_dir, name):
    fr, args, T = _case(name, request, out_dir)
    lib = load_host(fr.plan, out_dir)
    L = args[2].shape[1]
    stats = torch.zeros((len(trace.COUNTERS), max(fr.nsub, 1), L),
                        dtype=torch.int64)
    plain = F.host_step(lib, *args)
    counted = F.host_step(lib, *args, stats=stats)
    for what, a, b in zip(("y", "state", "fails", "iters", "floored"),
                          plain, counted):
        if what == "state":
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert torch.equal(a, b), what
    c = {k: stats[i] for k, i in C.items()}
    # the host's clock reads 0: no cycles
    for k in trace.COUNTERS[:6]:
        assert not c[k].any(), k
    iters = plain[3].long()
    if fr.nsub == 0:
        assert not stats.any()
        return
    assert torch.equal(c["ev_fast"] + c["ev_polish"] + c["ev_redo"], iters)
    assert (c["solves"] == T).all()
    assert (c["redos"] <= c["solves"]).all()
    if fr.plan.fast_path:
        assert (c["ev_fast"] == fr.plan.fast * T).all()
    else:
        # the robust path every sample: no keep test, no redo counted
        assert not c["redos"].any() and not c["ev_fast"].any()
    if name == "clipper":
        # levels up to 3.0 fail the keep test, those below 0.05 never do
        assert c["redos"][:, :128].any() and not c["redos"][:, 128:].any()
    if name == "main_redo":
        # lane 3 alone takes the redo, and its ladder
        others = np.delete(c["redos"].numpy(), 3, axis=1)
        assert c["redos"][:, 3].any() and not others.any()
        assert (c["homotopy"] <= c["redos"]).all()
        assert (c["df_rescues"] <= c["redos"]).all()
    if name == "full":
        assert fr.plan.subs[0]["fold"] and c["fold_passes"].any()
    # two launches add to one buffer: twice the counts
    once = stats.clone()
    F.host_step(lib, *args, stats=stats)
    assert torch.equal(stats, 2 * once)


def test_counters_are_the_kernels_rows():
    """``trace.COUNTERS`` names the rows of ``csrc/step.cuh``'s Stat, in
    its order."""
    with open(os.path.join(CSRC, "step.cuh")) as f:
        src = f.read()
    body = re.search(r"enum Stat \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "NSTAT"
    assert [n[3:].lower() for n in names[:-1]] == list(trace.COUNTERS)
    assert trace.TIERS == ("warm", "fast", "polish", "redo", "commit")


def test_stats_buffer_is_checked(out_dir):
    fr = FusedRunner(M.diodeclipper_model(), **PROD, device="cpu")
    u, lv, tol, gate = fr.prepare_inputs(_sine(1.5, 4), np.zeros((128, 0)))
    args = (fr.plan, u, lv, tol, gate, fr.initial_state(128),
            fr._coef_tables(128))
    lib = load_host(fr.plan, out_dir)
    for bad in (torch.zeros((len(trace.COUNTERS), 1, 64), dtype=torch.int64),
                torch.zeros((len(trace.COUNTERS), 1, 128))):
        with pytest.raises(ValueError, match="stats"):
            F.host_step(lib, *args, stats=bad)
    # the plain version counts no tiers
    with pytest.raises(ValueError, match="counts no tiers"):
        F.fused_step(*args, stats=torch.zeros(
            (len(trace.COUNTERS), 1, 128), dtype=torch.int64))


def _clipper_run(cold=True):
    fr = FusedRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                     powerup="safe", powerup_samples=8, **PROD, device="cpu")
    lv = np.linspace(0.1, 2.0, 128)[:, None]
    y, st, info = fr.run(_sine(1.5, 16), lv)
    return fr, lv, st, info


def test_tracing_off_records_nothing():
    assert not trace.on()
    fr, lv, st, info = _clipper_run()
    fr.run(_sine(1.5, 8), lv, state=st)
    assert info.tiers is None
    assert trace.records() == [] and trace.counters() == {}
    assert trace.tier_buffer(fr.plan, 128, "cpu") is None


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_recording_or_a_profiler_turns_tracing_on(how):
    if how == "recording":
        ctx = trace.recording()
    else:
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    with ctx as prof:
        assert trace.on()
        fr, lv, st, info = _clipper_run()
    assert not trace.on()
    names = [r.name for r in trace.records()]
    assert names.count("acme.run") == 3 and "acme.lane_tolerances" in names
    # on the CPU the plain version runs: spans, and no tier counters
    assert info.tiers is None and trace.counters() == {}
    if how == "profiler":
        # each span is also a range among the profiler's events
        seen = {e.name for e in prof.events()}
        assert {"acme.run", "acme.powerup", "acme.prepare_inputs",
                "acme.lane_tolerances", "acme.check_outputs",
                "acme.wait"} <= seen


def test_spans_nest_and_record_their_parents():
    """A cold run with a power-up, then a warm one: the spans' tree is the
    calls' and each span lies inside its parent on the host clock."""
    with trace.recording():
        fr, lv, st, info = _clipper_run()
        fr.run(_sine(1.5, 8), lv, state=st)
    recs = trace.records()
    tree = [(r.name, recs[r.parent].name if r.parent >= 0 else None)
            for r in recs]
    one_run = [("acme.prepare_inputs", "acme.run"),
               ("acme.lane_tolerances", "acme.prepare_inputs")]
    checked = [("acme.check_outputs", "acme.run"),
               ("acme.wait", "acme.check_outputs"),
               ("acme.wait", "acme.check_outputs")]
    assert tree == [("acme.run", None), ("acme.powerup", "acme.run"),
                    ("acme.run", "acme.powerup"), *one_run,
                    ("acme.run", "acme.powerup"), *one_run,
                    ("acme.check_outputs", "acme.powerup"), *checked[1:],
                    ("acme.run", None), *one_run, *checked]
    for r in recs:
        assert r.end >= r.start
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start <= r.start and r.end <= p.end
    snap = trace.snapshot()
    assert snap["runs"] == 2 and snap["spans"]["acme.wait"]["count"] == 4
    assert 0 < snap["host_self_ms"] <= snap["run_ms"]


def test_span_outside_tracing_is_a_no_op():
    with trace.span("acme.run"):
        pass
    assert trace.records() == []
    with trace.recording():
        with trace.recording():
            with trace.span("outer"):
                with trace.span("inner"):
                    pass
        assert trace.on()
    assert not trace.on()
    assert [(r.name, r.parent) for r in trace.records()] == \
        [("outer", -1), ("inner", 0)]


def test_tier_buffers_sums_and_snapshot():
    """The recorder keeps one buffer per plan, lane count, device and first
    lane, which every launch adds to; its sums by build and in all, and the
    tiers' shares of the launch cycles."""
    plan = SimpleNamespace(cuda_name=None, kernel_name="fused_sweep", nsub=2)
    assert trace.tier_buffer(plan, 4, "cpu") is None
    with trace.recording():
        buf = trace.tier_buffer(plan, 4, "cpu")
        assert trace.tier_buffer(plan, 4, "cpu") is buf
        half = [trace.tier_buffer(plan, 2, "cpu", lane0) for lane0 in (0, 2)]
    assert tuple(buf.shape) == (len(trace.COUNTERS), 2, 4)
    assert half[0] is not half[1] and not buf.any()
    call = torch.zeros_like(buf)
    call[C["total"], 0] = 1000
    call[C["polish"]] = 200
    call[C["redo"], 1] = 100
    call[C["solves"]] = 3
    call[C["redos"], 0, 0] = 1
    buf += call
    buf += call
    for lane0, h in zip((0, 2), half):
        h += call[:, :, lane0:lane0 + 2]
    by_build = trace.counters(by_build=True)
    assert set(by_build) == {"fused_sweep/4", "fused_sweep/2"}
    assert by_build["fused_sweep/2"]["solves"] == 24
    c = by_build["fused_sweep/4"]
    assert c["total"] == 8000 and c["polish"] == 3200 and c["redo"] == 800
    assert c["solves"] == 48 and c["redos"] == 2
    assert trace.counters()["solves"] == 72
    snap = trace.snapshot()["kernels"]["fused_sweep/4"]
    assert snap["counters"] == c
    shares = snap["tier_shares_pct"]
    assert shares["polish"] == 40.0 and shares["redo"] == 10.0
    assert shares["remainder"] == 50.0
    assert sum(shares.values()) == pytest.approx(100.0)
