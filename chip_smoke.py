"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py            # the whole run (needs one CUDA card)
    python3 chip_smoke.py --scaling  # phases 1, 2 and 4s alone
    python3 chip_smoke.py --engine   # the float64 scan engine's phases alone
    python3 chip_smoke.py --golden   # phase 5j alone, with what it needs
    python3 chip_smoke.py --ab ROOT [ROOT ...]
                                     # the same windows of each checkout
                                     # ROOT in turns, bit for bit
    python3 chip_smoke.py --trace-cost
                                     # the port's tracing on against off

Phases, each printed with its seconds:
  1. the device (name, power limit, torch / CUDA / nvcc versions); from
     here on, in two worker processes on the host, the float64 engine
     path's steady seeds: all 4096 lanes of the main path's grid in one
     batch, and its 18 parity lanes in a batch of their own;
  3. the models, built by the port's own compiler, the exact part of every
     Super Over build in a pool of worker processes: the main path's (the
     chain-decomposed Super Over with drive and tone as per-lane inputs,
     its runner preparation and the committed steady seeds), the level
     sweep's (the same circuit with fixed pots, its input scaled per
     lane), the presets sweep's (eight of those at other pot positions,
     the per-lane models of ONE runner: every coefficient that differs
     between them reaches the kernel in two per-lane tables), the
     un-decomposed Super Over (one 7x7 subsystem) and the un-decomposed
     Super Over with drive and tone as inputs (the golden phase's); the
     committed golden traces (tests/golden, tests/golden_torch);
  2. the nvcc builds of the fused kernel, started together (at most
     BUILD_WORKERS at a time): the clipper's, birdie's, the main path's,
     and for each of the three level-swept models two (the production
     configuration and the power-up sibling's); then, as their runners
     are prepared, one build per step configuration of the ablation
     (``acme_tpu_torch.ablate``: every configuration of the JAX
     package's ``_ablate.py``, the runner's own defaults and the knob
     values ``_ablate.py`` does not ablate, equal configurations sharing
     one build), of the main path's two
     stronger verdict tiers (``sweeps.VERDICT_TIERS``) and of the groups
     path (the main path's model under docs/tpu.md's quick-start with
     ``fast_iters=1``, the JAX defaults otherwise: lane groups of 2048,
     the build that couples them, ``VERIFY_GROUP``, and its twin with
     ``fast_verify="merge"``); the float64 scan engine's builds
     (``csrc/scan.cu`` with its engine header, each build both real
     types): the main path's Super Over, the level Super Over, the
     clipper (which also serves the float32 clipper and four clippers as
     per-lane models: the matrices are kernel arguments), and, started
     once the others are done and run beside phase 4's host-bound checks,
     the golden phase's: the Sallen-Key filter (linear: no nonlinear
     subsystem), birdie, the two un-decomposed Super Overs (the clipper's
     and the main path's builds serve their traces too), with ptxas's
     registers, stack frame and spills and the SASS size of each kernel
     entry; for the main path's production build and the full path's
     two (FRAMELESS_BUILDS) also the functions the inliner left as calls
     and their SASS loads and stores of local memory (LDL, STL), and a
     failure if a kernel entry of theirs has more stack frame than
     FRAME_BYTES or any spill store; meanwhile, in worker
     processes on the host, the presets path's float64 references;
  4. kernel against its plain torch version on the card: the diode
     clipper (128 lanes x 256 samples), birdie with its volume pot as a
     lane input (128 x 32), the Super Over (4096 x 32 from the seeds),
     and for the level, presets and full models the power-up build
     (4096 x 64 from cold; the full model's x 16) and the production
     build (the next 64 samples, 16 for the full model, from the state
     the power-up build left); each ablation build as the level
     model's (4096 x 64 from that state, its power-up build from cold),
     and the verdict tiers at 4096 x 16 from the seeds; the group build
     at 4096 x 16 from the seeds in its runner's partition (two groups
     of 2048), in one group of 4096 and in four of 1024, each bit for
     bit in y, state, fails, floored and iters, then its merge twin, and
     how many lanes' evaluations differ between the four (reported); then
     each engine build against its plain scan (``engine._plain_scan``, torch
     ops on the card) at -180 dB of each lane's peak with ``converged``
     equal: the clipper in float64 and float32 (128 x 256), four clippers
     as per-lane models (x 256), the level Super Over from cold (4096 x
     32), and once the seeds are there the main path's Super Over (4096 x
     32 from them) and its split over ``(cuda:0, cuda:0)``, bit for bit as
     unsplit; the golden phase's own engine builds over the first 32
     samples of their traces from the traces' starts; a kernel's time is the median of three launches queued
     behind a warm-up launch;
  5. the main path: 4096 lanes x 44100 samples from the seeds, chained
     for seven windows as the JAX package's bench chains them, each timed
     whole and kernel alone; window 1 is scored against the committed
     float64 power-up references and window 7 against the steady ones;
  5b. the level path: 4096 input levels x 44100 samples from cold, as the
     bench runs its level sweep: a power-up window (its first 4096 samples
     through the power-up build), one warm-up window and two timed chained
     windows; window 1 is scored against the "_pw" references and window 4
     against the "_st" ones; then the power-up build's launch alone
     again at the path's shape (4096 x 4096), for its own time and bound;
  5c. the presets path: 8 presets x 512 input levels (lane i runs model
     i % 8), the level path's input and protocol; no committed reference
     covers these circuits, so 16 lanes (each model's lowest and highest
     level) are scored against the port's float64 host runtime over the
     first 5120 samples of window 1: the power-up build's 4096 and the
     production build's first 1024, so the score crosses the handoff and
     holds the build that reads the per-lane tables in the production
     step;
  5d. the full path: the un-decomposed Super Over at 4096 input levels,
     the level path's protocol, scored on the 8 lanes the committed
     "scan2_level_full" references cover (windows 1 and 4);
  5e. the ablation path (``acme_tpu_torch.ablate``'s protocol at full
     width, its depth cut): the level path's model, lanes and input; one
     power-up window with the ablation's base configuration, then for
     each row (``ablate.ROWS``) one warm window and two timed chained
     windows (ablate.py's three, cut to ABLATION_REPS for phase 5i's
     time) from that state; its RT-factor per lane, fails, evaluations per
     sample, dB against the base, and window 4 (the second timed) scored
     against the level path's "_st" references; base and cf2 held to
     the level path's gate, every output held finite, the others
     recorded;
  5f. the verdict tiers of the JAX bench's ``--compare-verdicts``: the
     main path again (seven windows from the seeds) under the full-df
     verdict ("plainfinal") and under it with a df elimination on every
     subsystem ("dfsolve"), scored and gated as phase 5;
  5g. the groups path: three chained windows of the group build from
     the seeds, scored as phase 5 (window 1 against "_pw", window 3
     against "_st") and gated at the main path's worst and the level
     path's worst as its median (GROUPS_PARITY_MEDIAN_DB: the JAX
     defaults have no verdict tier), then one window of its merge twin
     from the same seeds: its cost, its dB against the references and
     against the group run's window 1, and the gate that the branch ran
     (window 1's evaluations differ from the twin's on some lane);
  5h. the mesh path: the main path's runner and the groups path's over a
     mesh that names the card twice (``FusedRunner(mesh=(cuda:0,
     cuda:0))``: two entries of 2048 lanes, each launched on a stream of
     its own, gathered on the card; the same builds): the main path's
     split against the plain version at 4096 x 16 from the seeds (kernel
     ms per entry), its first two windows from the seeds and the groups
     path's first (each entry one group of 2048, the unsplit partition),
     each bit for bit as phase 5's and phase 5g's in y, state, fails,
     iters and floored and timed beside them (kernel per entry, the span
     of the entries' launches and how far they overlapped); then the
     lanes the card holds resident for the groups path's build, and a
     group grid of at least twice as many lanes (the main path's lanes
     and seeds tiled, 16 samples) in one call, which launches batches of
     whole groups, bit for bit as its groups run one at a time;
  5i. the float64 scan engine's path, the protocol that made the
     committed references (bench.py:127-146) on the card at full width:
     the main path's Super Over at tol 1e-12 from the 4096-lane steady
     seeds, seven chained 1-s windows of ``run_sweep`` (ms per window and
     kernel ms, RT-factor per lane, Msamples/s, Newton iterations per
     lane-sample, non-converged lane-samples; for windows 1 and 7 each
     subsystem's mean Newton iterations per lane-sample against the mean
     of each warp's maximum, for warps of 32, 16, 8 and 4 lanes), window
     1 scored against "_pw" and window 7 against "_st" on the 18 parity
     lanes (worst <= -110 dB, median <= -120 dB); the same lanes' window
     1 from seeds computed in a batch of their own; the fused main path's
     windows 1 and 7 against the engine's on all 4096 lanes (worst lane
     with its drive and tone, and the median; reported); then the level
     sweep's window 1 through ``run`` from cold ((4096, 1, 44100)
     per-lane input) against the level "_pw" references, the same gates,
     and its warp divergence; and one window of each clipper build
     through its ``run``; the golden traces' lanes' furthest departure
     of the fused window 1 from the engine's (each from its own seeds);
  5j. the golden phase: the kernels against the committed 50-digit traces
     (``acme_tpu_torch.utils.golden``), each run from its trace's start:
     the engine kernel (tol 1e-12) on every trace, the traces of one model
     and length as the lanes of one launch, each within -110 dB of its
     trace's peak; the main path's production build on the lanes of the
     main path's traces (tests/golden_torch) from their committed seeds
     over the whole of window 1 (the trace's input, then the window's
     rest, chained), fails and floored 0, each lane's dB against its trace
     printed (not gated), beside the engine's from the same point over the
     same window and the sample where the two depart furthest; the same
     build on each resumed trace from the engine's carry there, one launch
     each (reported);
     the full path's production build on ``superover.npz`` from its
     steady state, within -65 dB;
  6. the kernel launch counts of each path, by build (library).
The "kernels" line has one entry per build: the main path's, the
production and power-up builds of the level, presets and full paths, each
ablation build (the level path's production build is also the ablation's
cf2) and its power-up build, the two verdict tiers' builds, and the
groups path's two; then one per engine build and real type (the main
path's Super Over, the level Super Over, the clipper in float64 and in
float32, four clippers as per-lane models), and one per engine build only
the golden phase runs (its launches there).
Each kernel's bound (the least time the card could take for the same
work) is the larger of its float operations, counted from the generated
code and the build's configuration (``ops.emit.op_counts``: its
evaluations in their tiers) with the evaluations per lane-sample the run
measured, over the H100's float32 peak, and its bytes (inputs read once,
outputs written once) over the card's memory rate.
The last line is {"ok": true, "device": {...}}; any failed phase exits
nonzero before it.

The engine's bound is the larger of its float operations
(``CompiledModel.op_counts``: each lane-sample's fixed work and each Newton
iteration's, times the iterations the run measured) over the H100's
float64 peak (float32 for the float32 build) and its bytes over the
memory rate.

Four runs alone, with no result line:
  4s. ``--scaling``: the main path's production build and the full
     path's at 4096, 8192, 16384 and 32768 lanes (the 4096 lanes' values
     and state tiled: the main path's from the seeds over 4096 samples,
     the full path's from where its power-up window left it over 2048),
     one launch each: kernel ms, aggregate lane-samples per second, and
     the first 4096 lanes bit for bit as the 4096-lane launch; ptxas's
     numbers, the calls the inliner left, the SASS size and its LDL and
     STL of each build; then the same for the
     engine's main build over 4096 samples, its lanes and state the 18
     parity lanes' values and steady seeds tiled (a worker process
     computes the seeds from the start);
  golden. ``--golden``: phase 5j with the phases it needs (the device,
     its models and builds, phase 4's rows for the engine builds only it
     runs);
  engine. ``--engine``: phases 1-3 for the engine alone (the main and
     level Super Overs, the engine builds and the seeds' workers), phase
     4's engine rows and phase 5i without the fused comparison;
  ab. ``--ab [--engine-only | --fused-only] [--full-scaling] ROOT
     [ROOT ...]``: for each checkout of the repo in the order given (a
     checkout named twice runs twice: parent, change, change, parent), a
     process of its own (``--windows ROOT``) that builds that checkout's
     main, level and full paths' builds (logging each build's ptxas
     numbers, calls, SASS size, and where it loads or stores local
     memory) and runs the main path's first two windows from the seeds
     and the level and full paths' first window from cold
     (``--full-scaling``: then phase 4s's full path), then its engine
     builds: the main build over one window of ``run_sweep`` from the 18
     parity lanes' steady seeds tiled to 4096 lanes (the seeds computed
     once per ``--ab`` run, before the first visit) and the level window
     through ``run`` from cold, each in float64 and float32, printing
     kernel ms per window (``--engine-only``: the engine's windows alone;
     ``--fused-only``: the fused paths alone); every visit's outputs bit
     for bit as the first's (a digest of y, state, fails, iters and
     floored; the engine's of y, state, converged and iters), each
     checkout's kernel ms against the first's.
  trace-cost. ``--trace-cost``: what the port's own tracing
     (``acme_tpu_torch.trace``) costs when on, in one process: the
     benchmark's ``full_level`` configuration (4096 input levels, its
     guitar stream from seed 7), warmed up from cold as the benchmark
     does, then one 4096-sample block from the same state 6 times in
     each of the turns off, on, on, off: per call the kernel ms (CUDA
     events) and the host ms (the call's wall ms less its kernel ms),
     medians by turn, every call's outputs bit for bit as the first's and
     the counts of every traced call equal; then the recorder's snapshot
     of the traced calls (the tier shares, the spans' mean ms), and what
     one span costs the host: off, inside ``trace.recording()`` and under
     a ``torch.profiler``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED_TAG = "seed2_pots_chain_fs44100_L4096"
FS = 44100
L_MAIN = 4096
# bench.py's reference protocols: window 1 is the power-up reference
# ("_pw"), window 2 + reps the steady one ("_st"); the main path runs
# five timed windows from the steady seeds, the level sweep two from cold
WINDOWS = 7
MAIN_REPS = 5
LEVEL_WINDOWS = 4
LEVEL_REPS = 2
# y agreement of two float32 implementations, relative to each lane's
# peak: their exp may differ by an ulp, which can move a lane onto another
# solver tier at a dead-zone crossing (tests/test_torch_fused.py's bound)
KERNEL_DB = -90.0
PARITY_WORST_DB = -50.0
PARITY_MEDIAN_DB = -95.0
# the level sweep: the JAX package's record on the same 16 lanes is -70.9
# (window 1) and -71.6 dB (steady window) worst
LEVEL_PARITY_WORST_DB = -65.0
# the presets sweep's models are the level sweep's at other pot positions:
# its gate, against the float64 host runtime over the first samples: all
# of the power-up build's span (powerup_samples) and the first 1024 of the
# production build's
PRESETS_PARITY_WORST_DB = -65.0
POWERUP_SAMPLES = 4096
PRESETS_REF_SAMPLES = POWERUP_SAMPLES + 1024
# the un-decomposed Super Over: the JAX package has no fused number for it
FULL_PARITY_WORST_DB = -65.0
# the ablation path: the base and cf2 (the level path's production build)
# held to the level path's gate in window 4; every configuration's output
# finite; the rest recorded
ABLATION_GATED = ("base", "cf2")
# phase 4's samples where the plain version takes longest (its time grows
# with the samples, and with the lanes only through the loops' trips):
# birdie and the Super Over from the seeds, the full model's builds, a
# verdict tier (the main path's lanes from the seeds); the others 64
POTS_CHECK_SAMPLES = 32
FULL_CHECK_SAMPLES = 16
TIER_CHECK_SAMPLES = 16
# the groups path's chained windows (window 1 against "_pw", the last
# against "_st"), and its gate: the main path's worst; its median at the
# level path's worst, since its configuration (the JAX defaults: a df
# polish loop and no verdict, so z carries no lo part) reads about -73 dB
# on these lanes with or without lane groups and with or without a fast
# path, where the main path's compensated verdict reads -98 dB
GROUPS_WINDOWS = 3
GROUPS_PARITY_MEDIAN_DB = -65.0
# the mesh path (phase 5h): the main path's first windows and the groups
# path's first over a mesh that names the card twice, each held bit for
# bit to its unsplit run; the group grid above the card's resident
# capacity over this many samples
MESH_WINDOWS = 2
RESIDENT_CHECK_SAMPLES = 16
# phase 4's timed launches of a kernel, queued behind its warm-up launch
CHECK_LAUNCHES = 3
# phase 4s: the main and full paths' production builds at these lane
# counts (their 4096 lanes and states tiled), one launch of this many
# samples each (half as many for the full path)
SCALING_LANES = (4096, 8192, 16384, 32768)
SCALING_SAMPLES = 4096
# --ab: the main path's chained windows from the seeds in each visit
AB_MAIN_WINDOWS = 2
# --trace-cost: the calls in each turn
TRACE_COST_CALLS = 6
# nvcc processes at a time
BUILD_WORKERS = 12
# the builds held without a local-memory frame (phase 2's keys): the main
# path's production build and the full path's two (the un-decomposed Super
# Over's 7x7 df elimination); each kernel entry's ptxas stack frame may not
# exceed FRAME_BYTES, and none may spill (nothing of the working set
# belongs in local memory, csrc/fused.cu)
FRAMELESS_BUILDS = ("superover", "full", "full powerup")
FRAME_BYTES = 0
# the float64 scan engine: the references' tolerance and the seeds'
# (bench.py:127-146); its kernel held to its plain version at this dB of
# each lane's peak; its path's parity gates against the committed float64
# references (stored as float32: about -135 dB is their own floor)
ENGINE_TOL = 1e-12
ENGINE_SEED_TOL = 1e-9
ENGINE_KERNEL_DB = -180.0
ENGINE_PARITY_WORST_DB = -110.0
ENGINE_PARITY_MEDIAN_DB = -120.0
# phase 4's engine checks: the main path's model from the seeds and the
# level model from cold, each 4096 lanes x this many samples
ENGINE_CHECK_SAMPLES = 32
ENGINE_LEVEL_CHECK_SAMPLES = 32
# the ablation's timed windows per row (ablate.REPS is 3; cut to 2 for the
# engine's phases, keeping window 4, the second timed one, which is scored)
ABLATION_REPS = 2
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and device memory
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "n/a"
    except (OSError, subprocess.SubprocessError):
        return "n/a"


def lane_db(a, b):
    """Per-lane max |a - b| relative to each lane's peak of b, in dB;
    a, b: (L, ny, T) arrays."""
    err = np.abs(a - b).max(axis=(1, 2)).astype(np.float64)
    peak = np.maximum(np.abs(b).max(axis=(1, 2)).astype(np.float64), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def bound(plan, L, T, evals, F, op_counts):
    """(ms, "operations" | "bytes"): the least time the card could take
    for one launch of ``plan``'s kernel over L lanes x T samples, with
    ``evals`` (nsub,) the measured evaluations per lane-sample of each
    subsystem."""
    per_sample, per_eval = op_counts(plan)
    ops = L * T * (per_sample + sum(float(e) * o
                                    for e, o in zip(evals, per_eval)))
    nstate = sum(F._state_dims(plan).values())
    nsub = max(plan.nsub, 1)
    nu_l = max(len(plan.lane_idx) + len(plan.scale_idx), 1)
    nbytes = 4 * (T * max(len(plan.time_idx), 1)      # u
                  + L * (nu_l + 4 * nsub)             # lanes, tol, gates
                  + 2 * L * max(plan.nvar, 1)         # coefficient tables
                  + 2 * L * nstate                    # state in and out
                  + T * max(plan.ny, 1) * L           # y
                  + L * (2 + nsub))                   # fails, floored, iters
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def compare_case(name, fr, u_time, lane_values, state, torch, F, op_counts,
                 group=None, exact=False):
    """Kernel (fused_step on CUDA tensors) against plain_run on the same
    CUDA tensors, in lane groups of ``group`` lanes where the build couples
    them; ``exact``: fail unless the two agree bit for bit in y, state,
    fails, floored and iters.  A runner with a mesh runs both through its
    split (each entry's launch on its own stream; the plain version on
    each entry's lanes), and its kernel ms are per entry.  Returns (a
    dict of the numbers it printed and the kernel's iters, the kernel's
    state)."""
    u, lv, tol, gate = fr.prepare_inputs(u_time, lane_values)
    coef = fr._coef_tables(lv.shape[1])
    state = {k: v.contiguous() for k, v in state.items()}
    args = (u, lv, tol, gate, state, coef, group)

    def step(fn):
        if fr.mesh is None:
            return fn(fr.plan, *args)
        return fr._mesh_step(fn, *args)
    entries = 1 if fr.mesh is None else len(fr.mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    # a warm-up launch (the first launch of a library also loads its
    # module), then the timed launches queued behind it, each timed alone
    # (fused.LAUNCH_EVENTS): the card runs them back to back, so the
    # wrapper's host work stays out of their time
    F.LAUNCH_EVENTS = []
    for _ in range(1 + CHECK_LAUNCHES):
        yk, stk, fk, ik, flk = step(F.fused_step)
    torch.cuda.synchronize()
    ms_k = float(np.median([a.elapsed_time(b)
                            for a, b in F.LAUNCH_EVENTS[entries:]]))
    F.LAUNCH_EVENTS = None
    ev[0].record()
    with torch.inference_mode():
        yp, stp, fp, ip, flp = step(F.plain_run)
    ev[1].record()
    torch.cuda.synchronize()
    ms_p = ev[0].elapsed_time(ev[1])
    yk_ = yk.permute(2, 1, 0).cpu().numpy()
    yp_ = yp.permute(2, 1, 0).cpu().numpy()
    if not np.isfinite(yk_).all():
        raise SmokeFailure(f"{name}: kernel output not finite")
    db = lane_db(yk_, yp_)
    worst = int(np.argmax(db))
    st_db = {}
    for key in ("x", "z", "zw", "wp", "dzdp"):
        a = stk[key].double() + (stk[key + "lo"].double()
                                 if key + "lo" in stk else 0)
        b = stp[key].double() + (stp[key + "lo"].double()
                                 if key + "lo" in stp else 0)
        scale = max(float(b.abs().max()), 1e-30)
        st_db[key] = 20 * np.log10(float((a - b).abs().max()) / scale
                                   + 1e-300)
    fails_eq = bool(torch.equal(fk, fp))
    floored_eq = bool(torch.equal(flk, flp))
    max_abs = float(np.abs(yk_ - yp_).max())
    T, L = u.shape[0], lv.shape[1]
    evals = ik.double().mean(dim=1).cpu().numpy() / T
    b_ms, b_by = bound(fr.plan, L, T, evals, F, op_counts)
    same = bool(torch.equal(yk, yp)) and all(
        bool(torch.equal(stk[k], stp[k])) for k in stp)
    iters_eq = bool(torch.equal(ik, ip))
    log(f"  {name}: L={L} T={T}  kernel {ms_k:.3f} ms, "
        f"plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})  "
        f"{'bit-identical' if same else 'NOT bit-identical'} (iters "
        f"{'equal' if iters_eq else 'differ'})  y worst lane "
        f"{worst}: {db[worst]:.1f} dB (median {np.median(db):.1f}), "
        f"max|dy| {max_abs:.3e}  fails {int(fk.sum())}/{int(fp.sum())} "
        f"floored {int(flk.sum())}/{int(flp.sum())}  evals/lane-sample "
        f"{evals.sum():.3f}  state dB "
        + " ".join(f"{k} {v:.1f}" for k, v in st_db.items()))
    bad = []
    if db[worst] > KERNEL_DB:
        bad.append(f"y {db[worst]:.1f} dB > {KERNEL_DB}")
    if not (fails_eq and floored_eq):
        bad.append("fails/floored differ")
    bad += [f"state {k} {v:.1f} dB" for k, v in st_db.items()
            if v > KERNEL_DB]
    if exact and not (same and iters_eq and fails_eq and floored_eq):
        bad.append("not bit for bit in y, state, fails, floored and iters")
    if bad:
        raise SmokeFailure(f"{name}: kernel disagrees with plain: {bad}")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_abs, bound_ms=b_ms,
                bound_by=b_by, iters=ik), stk


def drive_path(label, fr, u, lane_values, state, windows, keep, card, torch,
               F, op_counts, hold=0):
    """Chain ``windows`` runs of ``fr`` through its public ``run``, each
    timed whole (CUDA events around the call) and each kernel launch
    alone (``fused.LAUNCH_EVENTS``).  The launch counts are set to 0 just
    before and read just after.  Returns (the first and the last window's
    outputs on the lanes ``keep``, the launch counts by build, each
    window's (fails, floored) summed over the lanes, and each window's
    (ms, FusedInfo, kernel ms of each launch, the span from the first
    launch's start to the last one's end in ms, and for the first
    ``hold`` windows the whole (y, state) on the card, else None))."""
    T = u.shape[1]
    L = lane_values.shape[0]
    F.LAUNCHES.clear()
    F.LAUNCH_EVENTS = []
    rows = []
    y_first = y_last = None
    for w in range(windows):
        n0 = len(F.LAUNCH_EVENTS)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        y, state, info = fr.run(u, lane_values, state=state, check=True)
        e1.record()
        torch.cuda.synchronize()
        launched = F.LAUNCH_EVENTS[n0:]
        span = (max(e0.elapsed_time(b) for _, b in launched)
                - min(e0.elapsed_time(a) for a, _ in launched))
        rows.append((e0.elapsed_time(e1), info,
                     [a.elapsed_time(b) for a, b in launched], span,
                     (y, state) if w < hold else None))
        # finite over every lane (run's check); the reference lanes kept
        if w == 0:
            y_first = y[keep, 0].cpu().numpy()
        y_last = y[keep, 0].cpu().numpy()
    launches = dict(F.LAUNCHES)
    timed = len(F.LAUNCH_EVENTS)
    F.LAUNCH_EVENTS = None
    if timed != sum(launches.values()):
        raise SmokeFailure(f"{label}: {timed} kernel launches timed of "
                           f"{sum(launches.values())} over {windows} "
                           "windows")
    for w, (ms, info, k_ms, span, _) in enumerate(rows):
        fails = info.fails.cpu().numpy()
        fl = info.floored.cpu().numpy()
        its = info.iters.cpu().numpy()
        evals = its.mean(0) / T
        b_ms, b_by = bound(fr.plan, L, T, evals, F, op_counts)
        rt = (T / FS) / (ms / 1e3)
        if fr.mesh is None:
            kernel = (f"kernel {' + '.join(f'{k:.1f}' for k in k_ms)} ms, "
                      f"outside it {ms - sum(k_ms):.1f} ms = "
                      f"{100 * (ms - sum(k_ms)) / ms:.2f} %")
        else:
            # the entries' launches on their streams: how far they ran at
            # once (1: wholly, 0: one after another)
            overlap = ((sum(k_ms) - span) / (sum(k_ms) - max(k_ms))
                       if len(k_ms) > 1 else float("nan"))
            kernel = ("kernel per entry "
                      f"{' | '.join(f'{k:.1f}' for k in k_ms)} ms over a "
                      f"span of {span:.1f} ms, overlap {overlap:.3f}; "
                      f"outside the span {ms - span:.1f} ms = "
                      f"{100 * (ms - span) / ms:.2f} %")
        log(f"[{label}] window {w + 1}: {L} lanes x {T} samples "
            f"{ms:.1f} ms ({kernel}) | RT-factor per lane "
            f"{rt:.3f}x | {L * T / (ms / 1e3) / 1e6:.3f} Msamples/s | "
            f"fails mean {fails.mean():.4f} max {int(fails.max())} | "
            f"floored mean {fl.mean():.4f} max {int(fl.max())} | "
            f"evals/lane-sample {its.sum(1).mean() / T:.3f} | bound "
            f"{b_ms:.3f} ms ({b_by}, production build's counts) | card: "
            f"{card}")
    counts = [(int(info.fails.sum()), int(info.floored.sum()))
              for _, info, *_ in rows]
    return y_first, y_last, launches, counts, rows


def lane_scaling(label, fr, u, lane_values, state, card, torch, F, op_counts,
                 samples=SCALING_SAMPLES):
    """Phase 4s: one launch of ``fr``'s build at each lane count of
    SCALING_LANES (the 4096 lanes' values and state tiled) over
    ``samples`` samples, each timed with CUDA events: kernel ms, lane-samples
    per second, evaluations per lane-sample, and the first 4096 lanes bit
    for bit as the 4096-lane launch (the lanes are independent).  Returns
    {lanes: (kernel ms, digest of y, state, fails, iters and floored)}."""
    L0 = lane_values.shape[0]
    rates, first, out = {}, None, {}
    # the first launch of a library also loads its module
    F.fused_step(fr.plan, *fr.prepare_inputs(u[:, :16], lane_values),
                 state, fr._coef_tables(L0), fr._group(L0))
    floors = fr._steady_floors
    for L in SCALING_LANES:
        tiles = L // L0
        # the seeds' residual floors tiled with them (per-lane tolerances)
        if floors is not None:
            fr._steady_floors = np.tile(floors, (tiles, 1))
        ut, lv, tol, gate = fr.prepare_inputs(u[:, :samples],
                                              np.tile(lane_values, (tiles, 1)))
        fr._steady_floors = floors
        st = {k: v.repeat(1, tiles).contiguous() for k, v in state.items()}
        F.LAUNCH_EVENTS = []
        y, st_out, fails, iters, floored = F.fused_step(
            fr.plan, ut, lv, tol, gate, st, fr._coef_tables(L), fr._group(L))
        torch.cuda.synchronize()
        (a, b), = F.LAUNCH_EVENTS
        F.LAUNCH_EVENTS = None
        ms = a.elapsed_time(b)
        rate = L * samples / (ms / 1e3)
        evals = iters.double().mean(dim=1).cpu().numpy() / samples
        b_ms, b_by = bound(fr.plan, L, samples, evals, F, op_counts)
        if first is None:
            first = (y, st_out, fails, iters, floored)
        else:
            fy, fst, ff, fi, ffl = first
            bad = [] if torch.equal(y[:, :, :L0], fy) else ["y"]
            bad += [k for k in fst if not torch.equal(st_out[k][:, :L0],
                                                      fst[k])]
            bad += [n for n, a_, b_ in (("fails", fails[:L0], ff),
                                        ("iters", iters[:, :L0], fi),
                                        ("floored", floored[:L0], ffl))
                    if not torch.equal(a_, b_)]
            if bad:
                raise SmokeFailure(f"{label}: the first {L0} of {L} lanes "
                                   f"differ from the {L0}-lane launch in "
                                   f"{bad}")
        rates[L] = rate
        log(f"[{label}] {L} lanes x {samples} samples: kernel {ms:.1f} ms, "
            f"{rate / 1e6:.3f} M lane-samples/s ({rate / rates[L0]:.2f} x "
            f"the {L0}-lane rate), evals/lane-sample {evals.sum():.3f}, "
            f"bound {b_ms:.3f} ms ({b_by}) | card: {card}")
        out[L] = ms, tensors_digest(
            [y] + [st_out[k] for k in sorted(st_out)] + [fails, iters,
                                                          floored])
        del y, st_out
    return out


def full_scaling(label, fr, u, lv_level, card, torch, F, op_counts):
    """Phase 4s for the full path's build: its power-up window from cold,
    then ``lane_scaling`` from the state that window left, over half as
    many samples as the main path's."""
    *_, rows = drive_path(f"{label}'s power-up window", fr,
                          u[:, :2 * POWERUP_SAMPLES], lv_level, None, 1, [0],
                          card, torch, F, op_counts, hold=1)
    return lane_scaling(label, fr, u, lv_level, rows[0][4][1], card, torch, F,
                        op_counts, samples=SCALING_SAMPLES // 2)


def steady_windows_clean(label, counts):
    """No fails and no floored samples after the power-up window."""
    if any(c != (0, 0) for c in counts[1:]):
        raise SmokeFailure(f"{label}: (fails, floored) by window {counts}, "
                           "expected (0, 0) after window 1")


def powerup_alone(label, pr, u, lane_values, card, torch, F, op_counts):
    """A cold path's power-up launch once more, alone (the same cold start
    and input, so the same work): its own kernel time and evaluations,
    hence its own bound."""
    W, L = u.shape[1], lane_values.shape[0]
    F.LAUNCH_EVENTS = []
    _, _, info = pr.run(u, lane_values, check=True)
    torch.cuda.synchronize()
    (e0, e1), = F.LAUNCH_EVENTS
    F.LAUNCH_EVENTS = None
    evals = info.iters.double().mean(dim=0).cpu().numpy() / W
    b_ms, b_by = bound(pr.plan, L, W, evals, F, op_counts)
    log(f"[{label}] power-up launch alone: {L} lanes x {W} samples, kernel "
        f"{e0.elapsed_time(e1):.1f} ms, evals/lane-sample "
        f"{evals.sum():.3f}, bound {b_ms:.3f} ms ({b_by}) | card: {card}")


def cold_path(label, fr, u, lane_values, keep, card, torch, F, op_counts):
    """The bench's protocol for a sweep from cold: a power-up window, one
    warm-up window, two timed chained windows; then the power-up launch
    alone."""
    out = drive_path(label, fr, u, lane_values, None, LEVEL_WINDOWS, keep,
                     card, torch, F, op_counts)
    powerup_alone(label, fr._powerup_runner(), u[:, :fr.powerup_samples],
                  lane_values, card, torch, F, op_counts)
    return out


def score(label, lanes, descs, y_first, y_last, keys, last_window,
          worst_db, median_db=None):
    """bench.py's scoring: each lane's error relative to the peak of its
    steady reference; the first window against "_pw", the last against
    "_st".  Returns the worst and median dB of each."""
    db_pw, db_st = [], []
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        for j, (i, desc, key) in enumerate(zip(lanes, descs, keys)):
            ref_pw, ref_st = cache[key + "_pw"], cache[key + "_st"]
            scale = max(float(np.abs(ref_st).max()), 1e-12)
            db_pw.append(20 * np.log10(
                float(np.abs(y_first[j] - ref_pw).max()) / scale + 1e-300))
            db_st.append(20 * np.log10(
                float(np.abs(y_last[j] - ref_st).max()) / scale + 1e-300))
            log(f"    parity lane {i} ({desc}): window 1 {db_pw[-1]:.1f} "
                f"dB, window {last_window} {db_st[-1]:.1f} dB")
    bad, out = [], {}
    for name, dbs in (("window 1 (_pw)", db_pw),
                      (f"window {last_window} (_st)", db_st)):
        worst, med = max(dbs), float(np.median(dbs))
        out[name] = (worst, med)
        log(f"[{label}] parity {name} vs float64 references: worst "
            f"{worst:.1f} dB, median {med:.1f} dB over {len(dbs)} lanes")
        if worst > worst_db or (median_db is not None and med > median_db):
            bad.append(f"{name} worst {worst:.1f} / median {med:.1f} dB")
    if bad:
        raise SmokeFailure(f"{label}: parity outside {worst_db} / "
                           f"{median_db} dB: {bad}")
    return out


def host_reference(spec, inputs):
    """One preset's references: the Super Over of ``spec``, built here (a
    model does not pickle; the build is deterministic), run from cold by
    the float64 host runtime on each of ``inputs``, a fresh copy each."""
    from acme_tpu_torch import runtime
    from acme_tpu_torch.models import superover_model
    model = superover_model(**spec)
    return [runtime.run(copy.deepcopy(model), u)[0] for u in inputs]


def host_references(pool, specs, levels, lanes, u):
    """The presets path's references, started in ``pool``, one task per
    preset: for each lane in ``lanes`` its model (``specs[i % len(specs)]``)
    run from cold on ``level x u``.  Returns a function that waits for
    them and returns them in the order of ``lanes``."""
    by_model = {}
    for i in lanes:
        by_model.setdefault(i % len(specs), []).append(i)
    futs = {k: pool.submit(host_reference, specs[k],
                           [levels[i] * u for i in mine])
            for k, mine in by_model.items()}

    def collect():
        refs = {}
        for k, mine in by_model.items():
            refs.update(zip(mine, futs[k].result()))
        return [refs[i] for i in lanes]
    return collect


def steady_db(y, keys):
    """Each lane's max error against its "_st" reference relative to the
    reference's peak, in dB (phase 5b's window-4 score); y: (lanes, T)."""
    out = []
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        for yl, key in zip(y, keys):
            ref = cache[key + "_st"]
            scale = max(float(np.abs(ref).max()), 1e-12)
            out.append(20 * np.log10(float(np.abs(yl - ref).max()) / scale
                                     + 1e-300))
    return out


def header_key(plan, model_header):
    """The build a plan needs: equal headers share one library."""
    return hashlib.sha256(model_header(plan).encode()).hexdigest()


def score_presets(label, lanes, levels, drive, tone, y_first, refs, split,
                  worst_db):
    """Each lane's max error relative to its reference's peak, in dB, over
    the reference's samples before ``split`` (the power-up build's) and
    from it on (the production build's); the worst of each held to
    ``worst_db``."""
    spans = {"power-up build": slice(0, split),
             "production build": slice(split, None)}
    dbs = {name: [] for name in spans}
    for j, i in enumerate(lanes):
        n = len(refs[j])
        peak = max(float(np.abs(refs[j]).max()), 1e-12)
        err = np.abs(y_first[j][:n] - refs[j])
        for name, sl in spans.items():
            dbs[name].append(20 * np.log10(float(err[sl].max()) / peak
                                           + 1e-300))
        log(f"    parity lane {i} (drive {drive[i]:.2f}, tone {tone[i]:.2f}, "
            f"level {levels[i]:.4f}): window 1, samples 0-{split - 1} "
            f"{dbs['power-up build'][-1]:.1f} dB, {split}-{n - 1} "
            f"{dbs['production build'][-1]:.1f} dB of peak {peak:.4f}")
    bad = []
    for name, d in dbs.items():
        worst, med = max(d), float(np.median(d))
        log(f"[{label}] parity window 1 ({name}'s samples) vs the float64 "
            f"host runtime: worst {worst:.1f} dB, median {med:.1f} dB over "
            f"{len(d)} lanes")
        if worst > worst_db:
            bad.append(f"{name} worst {worst:.1f} dB")
    if bad:
        raise SmokeFailure(f"{label}: parity outside {worst_db} dB: {bad}")


def group_checks(fr_g, fr_m, u, lane_values, seed, torch, F, op_counts):
    """Phase 4's lane-group rows: the group build against the plain
    version from the seeds in the runner's partition (two groups of 2048),
    then as the partitions of ``group_lanes`` 4096 (one group) and 1024
    (four), each bit for bit, and the merge twin; then how many lanes'
    evaluations differ between them (reported, not gated: 16 samples may
    hold no failing lane, or one in every group).  Returns the rows of
    the runner's partition and of the merge twin."""
    L = lane_values.shape[0]
    out, iters = {}, {}
    for request in (fr_g.group_S * 128, 4096, 1024):
        part = copy.copy(fr_g)
        part.group_S = request // 128
        Lg = part.group_size(L)
        label = f"{L // Lg} x {Lg}"
        row, _ = compare_case(f"groups path, group_lanes={request}: "
                              f"groups {label}", fr_g, u, lane_values, seed,
                              torch, F, op_counts, group=Lg, exact=True)
        out.setdefault("group", row)
        iters[f"groups {label}"] = row["iters"]
    out["merge"], _ = compare_case("groups path's merge twin", fr_m, u,
                                   lane_values, seed, torch, F, op_counts,
                                   exact=True)
    iters["merge"] = out["merge"]["iters"]
    names = list(iters)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            n = int((iters[a] != iters[b]).any(0).sum())
            log(f"  groups path: lanes whose evaluations differ, {a} vs "
                f"{b}: {n} of {L}")
    return out


def groups_path(fr_g, fr_m, u, lane_values, seeds, lanes, descs, keys, card,
                torch, F, op_counts):
    """Phase 5g: the group build's chained windows from the seeds, scored
    as the main path (window 1 against "_pw", the last against "_st"),
    then one window of its merge twin from the same seeds: its cost, its
    dB against the group run's window 1 on every lane, and the gate that
    the branch ran (window 1's evaluations differ on some lane).  Returns
    the launch counts of the group run and of the twin's, and the group
    run's window 1 (ms, FusedInfo, kernel ms, span, (y, state))."""
    every = np.arange(lane_values.shape[0])
    y1, y_last, launches, counts, rows = drive_path(
        "5g groups path", fr_g, u, lane_values, seeds[0], GROUPS_WINDOWS,
        every, card, torch, F, op_counts, hold=1)
    log(f"[5g groups path] (fails, floored) by window: {counts}")
    score("5g groups path", lanes, descs, y1[lanes], y_last[lanes], keys,
          GROUPS_WINDOWS, PARITY_WORST_DB, GROUPS_PARITY_MEDIAN_DB)
    del y_last
    ym, _, m_launches, m_counts, m_rows = drive_path(
        "5g groups path, merge twin", fr_m, u, lane_values, seeds[1], 1,
        every, card, torch, F, op_counts)
    err = np.abs(ym - y1).max(axis=1).astype(np.float64)
    peak = np.maximum(np.abs(y1).max(axis=1).astype(np.float64), 1e-30)
    db = 20 * np.log10(err / peak + 1e-300)
    # the twin's window 1 against the float64 references (reported)
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        twin = [20 * np.log10(
            float(np.abs(ym[i] - cache[k + "_pw"]).max())
            / max(float(np.abs(cache[k + "_st"]).max()), 1e-12) + 1e-300)
            for i, k in zip(lanes, keys)]
    it_g, it_m = rows[0][1].iters, m_rows[0][1].iters
    differ = int((it_g != it_m).any(dim=1).sum())
    ev_g = float(it_g.sum(1).double().mean()) / u.shape[1]
    ev_m = float(it_m.sum(1).double().mean()) / u.shape[1]
    (ms_g, _, k_g, *_), (ms_m, _, k_m, *_) = rows[0], m_rows[0]
    log(f"[5g groups path] merge twin, window 1: (fails, floored) "
        f"{m_counts[0]}; against the float64 references worst "
        f"{max(twin):.1f} dB, median {np.median(twin):.1f} dB over "
        f"{len(twin)} lanes (reported); against the group run's window 1 "
        f"worst {db.max():.1f} dB, median {np.median(db):.1f} dB over "
        f"{len(db)} lanes; evals/lane-sample group {ev_g:.3f}, merge "
        f"{ev_m:.3f}; lanes whose evaluations differ: {differ} of "
        f"{len(db)}; the coupling costs {ms_g - ms_m:.1f} ms per window "
        f"({ms_g:.1f} against {ms_m:.1f}; kernel {sum(k_g):.1f} against "
        f"{sum(k_m):.1f}) | card: {card}")
    if differ == 0:
        raise SmokeFailure("5g groups path: window 1's evaluations equal "
                           "the merge twin's on every lane: nothing on the "
                           "path exercised the lane group")
    return launches, m_launches, rows[0]


def same_outputs(label, got, want):
    """Fail unless two windows' (ms, FusedInfo, kernel ms, span, (y,
    state)) rows agree bit for bit in y, state, fails, iters and
    floored."""
    (yg, sg), (yw, sw) = got[4], want[4]
    bad = [] if yg.equal(yw) else ["y"]
    bad += [k for k in sw if not sg[k].equal(sw[k])]
    # FusedInfo.tiers: None while tracing is off
    bad += [f for f, a, b in zip(got[1]._fields, got[1], want[1])
            if (a is None) != (b is None)
            or (a is not None and not a.equal(b))]
    if bad:
        raise SmokeFailure(f"{label}: not bit for bit as the unsplit run "
                           f"in {bad}")


def mesh_path(meshed, seeds, fr_so, fr_g, main_rows, group_row, u,
              lane_values, card, dev, torch, F, op_counts):
    """Phase 5h: the mesh ``(cuda:0, cuda:0)``, two entries of 2048 lanes
    each launching on its own stream.  The main path's split against the
    plain version at phase 4's shape (kernel ms per entry), then its first
    MESH_WINDOWS windows from the seeds and the groups path's first, each
    bit for bit as phase 5's and phase 5g's and timed beside them; then
    the group build over a grid of at least twice the lanes the card
    holds resident, bit for bit as its groups run one at a time."""
    L = lane_values.shape[0]
    check, _ = compare_case("mesh main path (kernel ms per entry)",
                            meshed["main"], u[:, :TIER_CHECK_SAMPLES],
                            lane_values, seeds["main"], torch, F, op_counts)
    out = {"check": check}
    for name, fr, rows0, windows in (("main", fr_so, main_rows, MESH_WINDOWS),
                                     ("groups", fr_g, [group_row], 1)):
        label = f"5h mesh {name} path"
        fr_m = meshed[name]
        if fr.plan.verify_group and fr_m.group_size(L) != fr.group_size(L):
            raise SmokeFailure(f"{label}: groups of {fr_m.group_size(L)} "
                               f"lanes, the unsplit run's {fr.group_size(L)}")
        _, _, launches, _, rows = drive_path(
            label, fr_m, u, lane_values, seeds[name], windows, [0], card,
            torch, F, op_counts, hold=windows)
        expected = {fr.plan.cuda_name: len(fr_m.mesh) * windows}
        log(f"[{label}] launches {launches}")
        if launches != expected:
            raise SmokeFailure(f"{label} launches {launches}, expected "
                               f"{expected}")
        for w, (row, row0) in enumerate(zip(rows, rows0)):
            same_outputs(f"{label} window {w + 1}", row, row0)
            ms, _, k_ms, span, _ = row
            ms0, _, k0, span0, _ = row0
            log(f"[{label}] window {w + 1} bit for bit as the unsplit "
                f"run's: {ms:.1f} ms against {ms0:.1f} ms; kernel per "
                f"entry {' | '.join(f'{k:.1f}' for k in k_ms)} ms over "
                f"{span:.1f} against one launch of {sum(k0):.1f} ms; "
                f"outside {ms - span:.1f} against {ms0 - span0:.1f} ms | "
                f"card: {card}")
        out[name] = [r[:4] for r in rows]
        del rows
    Lg = fr_g.group_size(L)
    cap = F.resident_lanes(fr_g.plan, dev, Lg)
    log(f"[5h resident capacity] {fr_g.plan.cuda_name}: {cap} lanes "
        f"resident at once, {cap // Lg} groups of {Lg} | card: {card}")
    if cap < Lg:
        raise SmokeFailure(f"one lane group of {Lg} lanes does not fit "
                           f"resident ({cap} lanes)")
    tiles = -(-2 * cap // L)
    Lb = tiles * L
    ub, lvb, tol, gate = fr_g.prepare_inputs(
        u[:, :RESIDENT_CHECK_SAMPLES], np.tile(lane_values, (tiles, 1)))
    lane_args = [lvb, tol, gate, *fr_g._coef_tables(Lb)]
    st = {k: v.repeat(1, tiles).contiguous()
          for k, v in seeds["groups"].items()}
    F.LAUNCH_EVENTS = []
    whole = F.fused_step(fr_g.plan, ub, *lane_args[:3], st, lane_args[3:],
                         Lg)
    parts = []
    for g in range(0, Lb, Lg):
        lv_g, tol_g, gate_g, ch, cl = [t[:, g:g + Lg].contiguous()
                                       for t in lane_args]
        parts.append(F.fused_step(
            fr_g.plan, ub, lv_g, tol_g, gate_g,
            {k: v[:, g:g + Lg].contiguous() for k, v in st.items()},
            (ch, cl), Lg))
    torch.cuda.synchronize()
    (a, b), *rest = F.LAUNCH_EVENTS
    F.LAUNCH_EVENTS = None
    ms_whole = a.elapsed_time(b)
    ms_parts = sum(x.elapsed_time(y) for x, y in rest)
    ys, sts, fails, iters, floored = zip(*parts)
    bad = [] if bool(torch.equal(whole[0], torch.cat(ys, 2))) else ["y"]
    bad += [k for k in whole[1]
            if not torch.equal(whole[1][k],
                               torch.cat([x[k] for x in sts], 1))]
    bad += [n for n, w, p in (("fails", whole[2], torch.cat(fails)),
                              ("iters", whole[3], torch.cat(iters, 1)),
                              ("floored", whole[4], torch.cat(floored)))
            if not torch.equal(w, p)]
    log(f"[5h resident capacity] {Lb} lanes x {RESIDENT_CHECK_SAMPLES} "
        f"samples ({Lb / cap:.2f} x the resident lanes, {Lb // Lg} groups) "
        f"in one call: {ms_whole:.1f} ms; its {Lb // Lg} groups one at a "
        f"time: {ms_parts:.1f} ms; "
        + ("bit for bit in y, state, fails, iters and floored" if not bad
           else f"NOT bit for bit: {bad}") + f" | card: {card}")
    if bad:
        raise SmokeFailure(f"5h: a group grid above the resident capacity "
                           f"differs from its groups one at a time in {bad}")
    out["resident"] = dict(lanes=cap, grid=Lb, ms=ms_whole,
                           one_at_a_time_ms=ms_parts)
    return out


def describe(name, m, fr, secs):
    subs = range(m.nsubsystems)
    log(f"[3 model] {name} nx={m.nx} nn={[m.nn(k) for k in subs]} "
        f"np={[m.np(k) for k in subs]} nq={[m.nq(k) for k in subs]} "
        f"nvar={fr.nvar} runner {secs:.1f}s; sub_fragile={fr.sub_fragile} "
        f"cond_eq={[float(f'{c:.3g}') for c in fr.sub_cond_eq]}")


def ablation_path(label, abl, base_pu, u, lane_values, lanes, keys, card,
                  torch, F, ablate, op_counts):
    """Phase 5e: the base's power-up window, then every row's warm window
    and ABLATION_REPS timed windows from that state (``ablate.measure``), each
    launch timed alone, with the bound of the last.  Returns ({row: its
    numbers}, the launch counts by build)."""
    F.LAUNCHES.clear()
    F.LAUNCH_EVENTS = []
    state0 = ablate.power_up(base_pu, lane_values, u)
    out, y_base = {}, None
    for name, fr in abl.items():
        n0 = len(F.LAUNCH_EVENTS)
        r = ablate.measure(fr, u, lane_values, state0, reps=ABLATION_REPS,
                           keep=lanes)
        k_ms = [a.elapsed_time(b) for a, b in F.LAUNCH_EVENTS[n0:]]
        y = r.pop("y")
        if name == "base":
            y_base, db = y, float("nan")
        else:
            db = ablate.vs_base_db(y, y_base)
        # window 4 of the level path's protocol: the second timed window
        w4 = steady_db(r["kept"][2], keys)
        b_ms, b_by = bound(fr.plan, len(lane_values), u.shape[1],
                           r["evals"], F, op_counts)
        r.update(db=db, w4_worst=max(w4), w4_median=float(np.median(w4)),
                 kernel_ms=k_ms, bound_ms=b_ms)
        out[name] = r
        secs = " ".join(f"{1e3 * x:.1f}" for x in r["secs"])
        log(ablate.row_line(name, r, db)
            + f"  window 4 vs _st worst {max(w4):.1f} dB median "
            f"{np.median(w4):.1f} | floored {r['floored']} | finite "
            f"{r['finite']} | windows {secs} ms (kernel "
            f"{' '.join(f'{x:.1f}' for x in k_ms)} ms, bound of the last "
            f"{b_ms:.3f} ms, {b_by}) | card: {card}")
        del y
    launches = dict(F.LAUNCHES)
    F.LAUNCH_EVENTS = None
    log(f"[{label}] summary (RT/lane, fails mean / max, evaluations per "
        "sample, dB against base, window 4 worst / median against the "
        "float64 references):")
    for name, r in out.items():
        log(f"  {name:10s} RT {r['rt']:6.3f}x  fails {r['fails_mean']:7.3f}"
            f"/{r['fails_max']:5d}  it/s {r['iters_per_sample']:6.3f}  "
            f"vs-base {r['db']:7.1f} dB  window 4 {r['w4_worst']:7.1f} / "
            f"{r['w4_median']:7.1f} dB")
    bad = [n for n, r in out.items() if not r["finite"]]
    bad += [f"{n} window 4 worst {out[n]['w4_worst']:.1f} dB"
            for n in ABLATION_GATED
            if out[n]["w4_worst"] > LEVEL_PARITY_WORST_DB]
    if bad:
        raise SmokeFailure(f"{label}: non-finite output or parity outside "
                           f"{LEVEL_PARITY_WORST_DB} dB: {bad}")
    return out, launches



# -- the float64 scan engine (phases 2, 4 and 5i) ----------------------------

def engine_seeds(lanes=None):
    """The main path's steady seeds, computed on the host as the JAX
    bench's references were (``compile_model(model, tol=1e-9)
    .steady_initial_state(lane_values, (1, 2))``) over the lanes ``lanes``
    of the 4096-lane grid (None: all of them, one batch).  Runs in a worker
    process (it builds its own model: a DiscreteModel does not pickle);
    returns (x, [(p, z, dzdp) per subsystem], seconds) as numpy arrays."""
    import torch
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.engine import compile_model
    t0 = time.time()
    m = S.build_model("pots", "chain", FS)
    _, _, _, lane_values, _ = S.lane_grid("pots", L_MAIN)
    if lanes is not None:
        lane_values = lane_values[list(lanes)]
    torch.set_num_threads(1)
    st = compile_model(m, tol=ENGINE_SEED_TOL, device="cpu") \
        .steady_initial_state(lane_values, (1, 2))
    return (st["x"].numpy(), [tuple(v.numpy() for v in w)
                              for w in st["warms"]], time.time() - t0)


def engine_state(seeds, dev, torch):
    """``engine_seeds``' arrays as an engine state on ``dev``."""
    from acme_tpu_torch.ops.newton import WarmStart
    D = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    x, warms, _ = seeds
    return {"x": D(x), "warms": tuple(WarmStart(*(D(v) for v in w))
                                      for w in warms)}


def engine_bound(cm, src, L, T, iters, torch):
    """(ms, "operations" | "bytes"): the least time the card could take
    for the engine's run of L lanes x T samples that needed ``iters``
    (T, L, nsub) Newton iterations: its float operations
    (``cm.op_counts()``: every lane-sample's fixed work plus each
    iteration's) over the card's float64 (float32) peak, or its bytes
    (model blocks, inputs, state in and out, y, converged, iters) over the
    memory rate."""
    per_sample, per_iter = cm.op_counts()
    its = iters.double().sum(dim=(0, 1)).cpu().numpy()
    ops = L * T * per_sample + sum(float(n) * o for n, o in zip(its,
                                                                per_iter))
    f64 = cm.dtype == torch.float64
    r = 8 if f64 else 4
    inputs = sum(t.numel() for t in (src.ut, src.ul, src.lv)
                 if t is not None)
    nbytes = r * (cm._blocks.numel() + inputs + 2 * L * cm._layout["ns"]
                  + T * L * cm.ny) + T * L * (1 + 4 * cm.nsub)
    t_ops = ops / (PEAK_FP64 if f64 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def engine_case(name, cm, src, state, T, torch, E):
    """The engine's kernel (``cm._scan`` on the card) against its plain
    version (``cm._plain_scan``) on the same CUDA tensors: y within
    ENGINE_KERNEL_DB of each lane's peak and converged equal, or fail;
    bit-identity and iterations reported.  A kernel's time is the median
    of CHECK_LAUNCHES launches queued behind a warm-up launch.  Returns
    the numbers it printed."""
    L = state["x"].shape[0]
    E.LAUNCH_EVENTS = []
    for _ in range(1 + CHECK_LAUNCHES):
        sk, (yk, ck, ik) = cm._scan(state, src, T)
    torch.cuda.synchronize()
    ms_k = float(np.median([a.elapsed_time(b)
                            for a, b in E.LAUNCH_EVENTS[1:]]))
    E.LAUNCH_EVENTS = None
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    sp, (yp, cp, ip) = cm._plain_scan(state, src, T, cm._mats())
    e1.record()
    torch.cuda.synchronize()
    ms_p = e0.elapsed_time(e1)
    if not bool(torch.isfinite(yk).all()):
        raise SmokeFailure(f"{name}: engine kernel output not finite")
    err = (yk - yp).abs().amax(dim=(0, 2)).double()
    peak = yp.abs().amax(dim=(0, 2)).double().clamp(min=1e-30)
    db = (20 * torch.log10(err / peak + 1e-300)).cpu().numpy()
    worst = int(np.argmax(db))
    same = bool(torch.equal(yk, yp)) and all(
        torch.equal(a, b) for a, b in zip(
            [sk["x"]] + [v for w in sk["warms"] for v in w],
            [sp["x"]] + [v for w in sp["warms"] for v in w]))
    conv_eq = bool(torch.equal(ck, cp))
    iters_eq = bool(torch.equal(ik, ip))
    b_ms, b_by = engine_bound(cm, src, L, T, ik, torch)
    max_abs = float((yk - yp).abs().max())
    log(f"  {name}: L={L} T={T}  kernel {ms_k:.3f} ms, plain {ms_p:.3f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})  "
        f"{'bit-identical' if same else 'NOT bit-identical'} (iters "
        f"{'equal' if iters_eq else 'differ'})  y worst lane {worst}: "
        f"{db[worst]:.1f} dB (median {np.median(db):.1f}), max|dy| "
        f"{max_abs:.3e}  converged {'equal' if conv_eq else 'DIFFER'}, "
        f"non-converged lane-samples {int((~ck).sum())}  Newton iterations "
        f"per lane-sample {float(ik.double().sum(-1).mean()):.3f}")
    bad = []
    if db[worst] > ENGINE_KERNEL_DB:
        bad.append(f"y {db[worst]:.1f} dB > {ENGINE_KERNEL_DB}")
    if not conv_eq:
        bad.append("converged differs")
    if bad:
        raise SmokeFailure(f"{name}: engine kernel disagrees with plain: "
                           f"{bad}")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_abs, bound_ms=b_ms,
                bound_by=b_by)


def engine_split(cm, u_time, lane_values, state, card, torch, E):
    """The main path's engine over the mesh ``(cuda:0, cuda:0)`` (two
    entries of 2048 lanes, each launched on a stream of its own, gathered
    on the card) against the unsplit run from the same state: bit for bit
    in y, state, converged and iters; kernel ms per entry."""
    from acme_tpu_torch.parallel import sharded_run_sweep
    dev = cm.device
    E.LAUNCH_EVENTS = []
    whole = cm.run_sweep(u_time, lane_values, (1, 2), state=state)
    split = sharded_run_sweep(cm, u_time, lane_values, (1, 2), (dev, dev),
                              state=state)
    torch.cuda.synchronize()
    (a, b), *entries = E.LAUNCH_EVENTS
    E.LAUNCH_EVENTS = None
    (yw, sw, iw), (ys, ss, is_) = whole, split
    leaves = lambda s: [s["x"]] + [v for w in s["warms"] for v in w]
    bad = [] if torch.equal(yw, ys) else ["y"]
    bad += ["state"] * (not all(torch.equal(p, q) for p, q in
                                zip(leaves(sw), leaves(ss))))
    bad += [n for n, p, q in (("converged", iw.converged, is_.converged),
                              ("iters", iw.iters, is_.iters))
            if not torch.equal(p, q)]
    log(f"  engine split over (cuda:0, cuda:0): {lane_values.shape[0]} lanes "
        f"x {u_time.shape[1]} samples, kernel per entry "
        f"{' | '.join(f'{x.elapsed_time(y):.3f}' for x, y in entries)} ms "
        f"against one launch of {a.elapsed_time(b):.3f} ms; "
        + ("bit for bit as unsplit in y, state, converged and iters"
           if not bad else f"NOT bit for bit: {bad}") + f" | card: {card}")
    if bad:
        raise SmokeFailure(f"engine split differs from unsplit in {bad}")


def engine_window_rows(label, rows, L, card):
    """Print each window of an engine drive: (ms, kernel ms, RunInfo,
    T, bound)."""
    for w, (ms, k_ms, info, T, b) in enumerate(rows):
        its = info.iters.double()
        log(f"[{label}] window {w + 1}: {L} lanes x {T} samples {ms:.1f} ms "
            f"(kernel {k_ms:.1f} ms, outside it {ms - k_ms:.1f} ms = "
            f"{100 * (ms - k_ms) / ms:.2f} %) | RT-factor per lane "
            f"{(T / FS) / (ms / 1e3):.3f}x | "
            f"{L * T / (ms / 1e3) / 1e6:.3f} Msamples/s | Newton iterations "
            f"per lane-sample {float(its.sum(-1).mean()):.3f} (per "
            f"subsystem {[round(float(v), 3) for v in its.mean((0, 1))]}) | "
            f"non-converged lane-samples {int((~info.converged).sum())} | "
            f"bound {b[0]:.3f} ms ({b[1]}) | card: {card}")


def warp_divergence(label, iters, card, torch, widths=(32, 16, 8, 4)):
    """Newton iterations of each subsystem (``iters`` (T, L, nsub), the
    kernel's own output): the mean per lane-sample, the mean over samples
    and warps of each warp's maximum for warps of ``widths`` consecutive
    lanes (a warp runs a subsystem's loop as long as its slowest lane), and
    their ratio; then the same summed over the subsystems (a sample's
    cost).  Returns {width: ratio of the sums}."""
    T, L, n = iters.shape
    mean = iters.sum(dim=(0, 1), dtype=torch.float64) / (T * L)
    fmt = lambda v: "[" + ", ".join(f"{float(x):.3f}" for x in v) + "]"
    parts, out = [f"mean {fmt(mean)} (sum {float(mean.sum()):.3f})"], {}
    for w in widths:
        if L < w:
            continue
        top = iters[:, :L // w * w].reshape(T, L // w, w, n).amax(dim=2) \
            .sum(dim=(0, 1), dtype=torch.float64) / (T * (L // w))
        out[w] = float(top.sum() / mean.sum())
        parts.append(f"{w}-lane warps' max {fmt(top)} (sum "
                     f"{float(top.sum()):.3f}), ratio {fmt(top / mean)} "
                     f"(sums {out[w]:.3f})")
    log(f"[{label}] warp divergence, Newton iterations per lane-sample by "
        f"subsystem: " + "; ".join(parts) + f" | card: {card}")
    return out


def engine_drive(cm, call, windows, keep, torch, E):
    """``windows`` chained calls ``call(state) -> (y, state, info)``, each
    timed whole (CUDA events) and its launch alone; keeps window 1's and
    the last window's y (whole, on the card) when ``keep``.  The launch
    counts are set to 0 just before and read just after.  Returns (rows,
    y of window 1, y of the last window, launch counts, the last state)."""
    E.LAUNCHES.clear()
    E.LAUNCH_EVENTS = []
    rows, y1, y_last, state = [], None, None, None
    for w in range(windows):
        n0 = len(E.LAUNCH_EVENTS)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        y, state, info = call(state)
        e1.record()
        torch.cuda.synchronize()
        k_ms = sum(a.elapsed_time(b) for a, b in E.LAUNCH_EVENTS[n0:])
        rows.append([e0.elapsed_time(e1), k_ms, info, y.shape[-1]])
        if not bool(torch.isfinite(y).all()):
            raise SmokeFailure(f"engine window {w + 1}: non-finite output")
        if keep and w == 0:
            y1 = y
        if keep and w == windows - 1:
            y_last = y
        del y
    launches = dict(E.LAUNCHES)
    E.LAUNCH_EVENTS = None
    return rows, y1, y_last, launches, state


def engine_score(label, lanes, descs, keys, ys, torch, worst_db, median_db):
    """bench.py's scoring of engine windows: each lane's max error over the
    peak of its steady ("_st") reference; ``ys`` {suffix: y (L, 1, T) on
    the card}.  Gates: worst and median of each window.  Returns
    {suffix: (dB per lane)}."""
    out = {}
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        for suffix, y in ys.items():
            yl = y[list(lanes), 0].cpu().numpy()
            dbs = []
            for j, key in enumerate(keys):
                ref = cache[key + suffix].astype(np.float64)
                scale = max(float(np.abs(cache[key + "_st"]).max()), 1e-12)
                dbs.append(20 * np.log10(float(np.abs(yl[j] - ref).max())
                                         / scale + 1e-300))
            out[suffix] = dbs
    for j, (i, desc) in enumerate(zip(lanes, descs)):
        log(f"    parity lane {i} ({desc}): " + ", ".join(
            f"{suffix} {out[suffix][j]:.1f} dB" for suffix in out))
    bad = []
    for suffix, dbs in out.items():
        worst, med = max(dbs), float(np.median(dbs))
        j = int(np.argmax(dbs))
        log(f"[{label}] parity {suffix} vs the committed float64 references: "
            f"worst {worst:.1f} dB (lane {lanes[j]}, {descs[j]}), median "
            f"{med:.1f} dB over {len(dbs)} lanes")
        if worst > worst_db or med > median_db:
            bad.append(f"{suffix} worst {worst:.1f} (lane {lanes[j]}, "
                       f"{descs[j]}) / median {med:.1f} dB")
    if bad:
        raise SmokeFailure(f"{label}: parity outside {worst_db} / "
                           f"{median_db} dB: {bad}")
    return out


def fused_vs_engine(label, y_fused, y_engine, scale_from, drive, tone,
                    lanes, torch):
    """A fused window (host float32, (L, T)) against the engine's same
    window (card float64, (L, 1, T)) on every lane: each lane's max error
    over the peak of the engine's ``scale_from`` window on that lane, in
    dB; the worst lane with its drive and tone, the median, the same on
    the parity lanes ``lanes`` (the bench's sample), and the worst and
    median of each eighth of the drive range.  Reported, not gated."""
    yf = torch.as_tensor(y_fused, device=y_engine.device).double()
    err = (yf - y_engine[:, 0]).abs().amax(dim=1)
    peak = scale_from[:, 0].abs().amax(dim=1).clamp(min=1e-12)
    db = (20 * torch.log10(err / peak + 1e-300)).cpu().numpy()
    w = int(np.argmax(db))
    sample = db[list(lanes)]
    log(f"[{label}] fused main path against the float64 engine over all "
        f"{len(db)} lanes: worst {db[w]:.1f} dB (lane {w}, drive "
        f"{drive[w]:.3f}, tone {tone[w]:.3f}), median {np.median(db):.1f} "
        f"dB; lanes above -50 dB: {int((db > -50).sum())}, above -90 dB: "
        f"{int((db > -90).sum())}; on the {len(sample)} parity lanes worst "
        f"{sample.max():.1f}, median {np.median(sample):.1f} dB")
    order = np.argsort(drive, kind="stable")
    for part in np.array_split(order, 8):
        log(f"    drive {drive[part].min():.3f}-{drive[part].max():.3f}: "
            f"worst {db[part].max():.1f} dB, median "
            f"{np.median(db[part]):.1f} dB over {len(part)} lanes")
    return float(db[w]), float(np.median(db)), w



CLIPPER_RS = (820.0, 1000.0, 1500.0, 4700.0)


def engine_runners(m_so, m_lvl, dev, torch):
    """The engine builds' runners: the main path's Super Over and the level
    Super Over at the references' tolerance, the clipper in float64 and in
    float32 (one build, two real types), and four clippers as per-lane
    models (the clipper's build, its matrices per lane)."""
    from acme_tpu_torch import DiscreteModel, resistor
    from acme_tpu_torch.engine import compile_model, compile_models
    from acme_tpu_torch.models import diodeclipper, diodeclipper_model

    def clipper(r):
        c = diodeclipper()
        c.delete("r1")
        c.add("r1", resistor(r))
        c.connect(("r1", 1), ("j_in", "+"))
        c.connect(("r1", 2), ("d1", "+"))
        return DiscreteModel(c, 1 / FS)
    return {"main": compile_model(m_so, tol=ENGINE_TOL, device=dev),
            "level": compile_model(m_lvl, tol=ENGINE_TOL, device=dev),
            "clipper": compile_model(diodeclipper_model(), device=dev),
            "clipper f32": compile_model(diodeclipper_model(),
                                         dtype=torch.float32, device=dev),
            "four clippers": compile_models([clipper(r) for r in CLIPPER_RS],
                                            device=dev)}


def start_engine_builds(ex, engines, B):
    """One nvcc per distinct engine header, started in ``ex``: {header:
    (runner names, future of the library's path)}."""
    builds = {}
    for name, cm in engines.items():
        if cm._header not in builds:
            builds[cm._header] = ([], ex.submit(B.compile_engine, cm._header))
        builds[cm._header][0].append(name)
    return builds


def entry_label(name):
    """An engine kernel entry's mangled name as its real type and, where
    the build has both, where its model block lives."""
    k = re.search(r"acme_scan_kernelI([df])(?:Lb([01])E)?", name)
    if not k:
        return name
    return ("f64" if k.group(1) == "d" else "f32") + (
        "" if k.group(2) is None else ", shared model block"
        if k.group(2) == "1" else ", per-lane model blocks")


def ptxas_entries(out):
    """ptxas -v's numbers for each kernel entry in a build's log: [(entry,
    registers, stack frame bytes, spill store bytes, spill load bytes)],
    an engine entry named by ``entry_label``."""
    rows, name, props = [], None, None
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, props = entry_label(m.group(1)), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name is not None:
            props = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.append((name, int(m.group(1))) + props)
            name = None
    return rows


def log_engine_builds(builds, engines, B):
    """Phase 2's lines for the engine builds: nvcc seconds, and for each
    kernel entry ptxas's registers, stack frame and spills and its SASS
    size; then each runner's library loaded."""
    for names, fut in builds.values():
        path = fut.result()
        secs, out = B.LAST_BUILD.get(path, (0.0, "(cached)"))
        log(f"[2 build] engine {' = '.join(names)} (scan.cu, float64 and "
            f"float32): nvcc {secs:.1f}s -> {os.path.basename(path)}")
        sass = {entry_label(k): n for k, n in sass_sizes(path).items()}
        for entry, regs, frame, st, ld in ptxas_entries(out):
            log(f"    ptxas: {entry}: {regs} registers, {frame} bytes stack "
                f"frame, {st} bytes spill stores, {ld} bytes spill loads; "
                f"SASS {sass.get(entry, 0)} instructions")
    for cm in engines.values():
        cm._library()


def engine_checks(eng, u, levels, torch, E):
    """Phase 4's engine rows that need no seeds: the clipper (128 lanes x
    256 samples of levels 0.1-3.0) in float64 and float32, four clippers
    as per-lane models (x 256), the level Super Over from cold (4096 x
    ENGINE_LEVEL_CHECK_SAMPLES, its per-lane input series)."""
    from acme_tpu_torch.engine import _Src
    Tc = 256
    uc = np.sin(2 * np.pi * 1000 / FS * np.arange(Tc))
    amps = np.linspace(0.1, 3.0, 128)
    series = lambda cm, a: _Src(umap=tuple((2, i) for i in range(cm.nu)),
                                ul=cm._as(a))
    checks = {}
    for name, label in (("clipper", "engine clipper (float64)"),
                        ("clipper f32", "engine clipper (float32)")):
        cm = eng[name]
        checks[name] = engine_case(label, cm, series(
            cm, amps[:, None, None] * uc[None, None]), cm.initial_state(128),
            Tc, torch, E)
    bm = eng["four clippers"]
    checks["four clippers"] = engine_case(
        "engine four clippers (per-lane models)", bm,
        series(bm, np.tile(2.0 * uc, (len(CLIPPER_RS), 1, 1))),
        bm.initial_state(), Tc, torch, E)
    cl = eng["level"]
    Tl = ENGINE_LEVEL_CHECK_SAMPLES
    checks["level"] = engine_case(
        "engine level Super Over (cold)", cl,
        series(cl, levels[:, None, None] * u[None, :, :Tl]),
        cl.initial_state(len(levels)), Tl, torch, E)
    return checks


def engine_clipper_runs(eng, torch, E):
    """One window of each clipper build through its public ``run`` (128
    input levels for the single model, one input for the per-lane models),
    the launch counts set to 0 just before each and read just after."""
    u = np.sin(2 * np.pi * 1000 / FS * np.arange(FS))
    out = {}
    for name, uu in (("clipper", np.linspace(0.1, 3.0, 128)[:, None, None]
                      * u[None, None]),
                     ("clipper f32", np.linspace(0.1, 3.0, 128)[:, None, None]
                      * u[None, None]),
                     ("four clippers", 2.0 * u[None])):
        rows, _, _, launches, _ = engine_drive(
            eng[name], lambda st, cm=eng[name], uu=uu: cm.run(uu), 1, False,
            torch, E)
        ms, k_ms, info, T = rows[0]
        log(f"[5i engine {name}] one window: {tuple(info.converged.shape)} "
            f"(samples, lanes) in {ms:.1f} ms (kernel {k_ms:.1f} ms), "
            f"non-converged lane-samples {int((~info.converged).sum())}, "
            f"launches {launches}")
        out[name] = launches
    return out


def engine_path(eng, seed_state, seeds18, u, lane_values, drive, tone,
                levels, fused, card, torch, E, S):
    """Phase 5i: the protocol that made the committed references
    (bench.py:127-146) on the card at full width.  The main path's model
    at tol 1e-12 from the 4096-lane steady seeds, seven chained 1-s
    windows of ``run_sweep`` (the 0.2-amplitude 1 kHz sine, drive and tone
    per lane), window 1 scored against "_pw" and window 7 against "_st" on
    the 18 parity lanes; the same lanes' window 1 from seeds computed in a
    batch of their own; the fused main path's windows 1 and 7 (``fused``,
    host float32, every lane) against the engine's over all 4096 lanes;
    then the level sweep's window 1 through ``run`` from cold, (4096, 1,
    44100) per-lane input, scored against the level "_pw" references.
    Returns the launch counts of the main drive and of the level window,
    and the numbers for PERF.md."""
    from acme_tpu_torch.engine import _Src
    cm = eng["main"]
    L, T = lane_values.shape[0], u.shape[1]
    ut, lv = cm._as(u), cm._as(lane_values)
    src = cm._sweep_src(ut, lv, (1, 2))
    rows, y1, y7, launches, _ = engine_drive(
        cm, lambda st: cm.run_sweep(ut, lv, (1, 2),
                                    state=seed_state if st is None else st),
        WINDOWS, True, torch, E)
    for r in rows:
        r.append(engine_bound(cm, src, L, T, r[2].iters, torch))
    engine_window_rows("5i engine path", rows, L, card)
    out_div = {w: warp_divergence(f"5i engine path, window {w}",
                                  rows[w - 1][2].iters, card, torch)
               for w in (1, WINDOWS)}
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    descs = [f"drive {drive[i]:.3f}, tone {tone[i]:.3f}" for i in lanes]
    keys = [S.ref_key("pots", "chain", FS, T, MAIN_REPS, 1.0, drive[i],
                      tone[i], powerup="steady") for i in lanes]
    out = {"windows": [(r[0], r[1]) for r in rows], "divergence": out_div}
    out["parity"] = engine_score("5i engine path", lanes, descs, keys,
                                 {"_pw": y1, "_st": y7}, torch,
                                 ENGINE_PARITY_WORST_DB,
                                 ENGINE_PARITY_MEDIAN_DB)
    # the seeds' batch: the ramp of steadystate_sweep starts from the
    # lanes' mean, so the 18 lanes seeded alone start elsewhere
    st18 = engine_state(seeds18, cm.device, torch)
    x_all = seed_state["x"][list(lanes)]
    dx = float((st18["x"] - x_all).abs().max())
    y18, _, _ = cm.run_sweep(ut, lv[list(lanes)], (1, 2), state=st18)
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        db18 = [20 * np.log10(float(np.abs(
            y18[j, 0].cpu().numpy() - cache[k + "_pw"]).max())
            / max(float(np.abs(cache[k + "_st"]).max()), 1e-12) + 1e-300)
            for j, k in enumerate(keys)]
    d_runs = (y18[:, 0] - y1[list(lanes), 0]).abs().amax(dim=1) \
        / y7[list(lanes), 0].abs().amax(dim=1)
    d_runs = (20 * torch.log10(d_runs + 1e-300)).cpu().numpy()
    log(f"[5i engine path] the 18 parity lanes seeded as a batch of their "
        f"own: seeds' x within {dx:.3e} of the 4096-lane batch's; window 1 "
        f"against \"_pw\" worst {max(db18):.1f} dB, median "
        f"{np.median(db18):.1f} dB; against the 4096-lane seeds' window 1 "
        f"worst {d_runs.max():.1f} dB, median {np.median(d_runs):.1f} dB")
    out["seed_batch"] = (dx, max(db18), float(np.median(db18)),
                         float(d_runs.max()))
    del y18
    if fused is not None:
        out["fused_w1"] = fused_vs_engine("5i fused vs engine, window 1",
                                          fused[0], y1, y7, drive, tone,
                                          lanes, torch)
        out["fused_w7"] = fused_vs_engine(f"5i fused vs engine, window "
                                          f"{WINDOWS}", fused[1], y7, y7,
                                          drive, tone, lanes, torch)
        # the golden traces' lanes (each runtime from its own seeds here)
        gl = sorted({int(t["lane"]) for g, t in golden_traces().values()
                     if g == "main"})
        golden_peaks("5i fused vs engine, window 1", fused[0][gl],
                     y1[gl, 0].cpu().numpy(), gl, drive, tone)
    del y1, y7
    cl = eng["level"]
    lvl_u = cl._as(levels)[:, None, None] * cl._as(u)[None]
    lsrc = _Src(umap=((2, 0),), ul=lvl_u)
    rows_l, yl1, _, launches_l, _ = engine_drive(
        cl, lambda st: cl.run(lvl_u), 1, True, torch, E)
    rows_l[0].append(engine_bound(cl, lsrc, L, T, rows_l[0][2].iters, torch))
    engine_window_rows("5i engine level window", rows_l, L, card)
    out["level_divergence"] = warp_divergence("5i engine level window",
                                              rows_l[0][2].iters, card, torch)
    lanes_l = S.select_parity_lanes(L_MAIN, 16,
                                    S.stress_lanes("level", L_MAIN))
    out["level_window"] = (rows_l[0][0], rows_l[0][1])
    out["level_parity"] = engine_score(
        "5i engine level window", lanes_l,
        [f"level {levels[i]:.4f}" for i in lanes_l],
        [S.ref_key("level", "chain", FS, T, LEVEL_REPS, levels[i], 1.0, 1.0)
         for i in lanes_l], {"_pw": yl1}, torch, ENGINE_PARITY_WORST_DB,
        ENGINE_PARITY_MEDIAN_DB)
    del yl1, lvl_u
    return launches, launches_l, out


def engine_entries(eng, checks, launches):
    """The "kernels" line's engine entries: one per build and real type,
    with the phase-4 numbers of its check and its launches on its drive."""
    out = []
    for key, name, drive in (
            ("main", "scan (Super Over pots, float64, engine path)", "main"),
            ("level", "scan (level Super Over, float64, engine path's level "
             "window)", "level"),
            ("clipper", "scan (clipper, float64)", "clipper"),
            ("clipper f32", "scan (clipper, float32)", "clipper f32"),
            ("four clippers", "scan (four clippers as per-lane models, "
             "float64)", "four clippers")):
        c = checks[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "acme_tpu_torch/ops/csrc/scan.cu",
            "replaces": "acme_tpu/engine.py:247-279",
            "launches": launches[drive].get(eng[key].launch_key(), 0),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    return out


def engine_launch_checks(eng, launches, expected):
    """Fail unless each engine drive launched its build's kernel exactly
    as often as expected, and no other."""
    for drive, n in expected.items():
        want = {eng[drive].launch_key(): n}
        log(f"[6 launches] engine {drive}: {launches[drive]}")
        if launches[drive] != want:
            raise SmokeFailure(f"engine {drive} launches {launches[drive]}, "
                               f"expected {want}")


# -- the golden phase (5j): the kernels against 50-digit traces --------------

# the committed traces: the JAX package's seven (tests/golden, each model
# as tests/test_golden.py builds it, by group) and the main path's
# (tests/golden_torch, group "main")
GOLDEN_COMMITTED = {"diodeclipper": "diodeclipper", "sallenkey": "sallenkey",
                    "birdie": "birdie", "superover": "superover",
                    "superover_pots_lo": "superover_pots",
                    "superover_pots_mid": "superover_pots",
                    "superover_pots_hi": "superover_pots"}
# the engine builds that only the golden phase runs (the clipper's and the
# main path's are phase 2's): phase 4 holds each against its plain version
# over this many samples of its traces
GOLDEN_OWN_BUILDS = ("sallenkey", "birdie", "superover", "superover_pots")
GOLDEN_CHECK_SAMPLES = 32


def golden_traces():
    """{name: (group, trace)}: every committed trace, each a dict of its
    npz's arrays."""
    out = {}
    for name, group in GOLDEN_COMMITTED.items():
        with np.load(os.path.join(HERE, "tests", "golden",
                                  f"{name}.npz")) as f:
            out[name] = (group, dict(f))
    d = os.path.join(HERE, "tests", "golden_torch")
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as f:
                out[fn[:-4]] = ("main", dict(f))
    if not any(g == "main" for g, _ in out.values()):
        raise SmokeFailure(f"no main-path trace in {d}")
    return out


def golden_engines(m_full, m_pots, m_so, dev):
    """The engine at the references' tolerance on each golden group's
    model (the Super Overs copies as built): {"golden <group>":
    CompiledModel}."""
    from acme_tpu_torch.engine import compile_model
    from acme_tpu_torch.models import (birdie_model, diodeclipper_model,
                                       sallenkey_model)
    models = {"diodeclipper": diodeclipper_model(fs=FS),
              "sallenkey": sallenkey_model(fs=FS),
              "birdie": birdie_model(vol=0.8, fs=FS),
              "superover": m_full, "superover_pots": m_pots, "main": m_so}
    return {"golden " + g: compile_model(m, tol=ENGINE_TOL, device=dev)
            for g, m in models.items()}


def golden_checks(eng, traces, torch, E):
    """Phase 4's rows for the engine builds only the golden phase runs:
    each against its plain version over the first GOLDEN_CHECK_SAMPLES of
    its traces (one lane each), from their starts."""
    from acme_tpu_torch.engine import _Src
    from acme_tpu_torch.utils.golden import engine_start
    checks = {}
    n = GOLDEN_CHECK_SAMPLES
    for g in GOLDEN_OWN_BUILDS:
        cm = eng["golden " + g]
        trs = [t for gg, t in traces.values() if gg == g]
        src = _Src(umap=tuple((2, i) for i in range(cm.nu)),
                   ul=cm._as(np.stack([t["u"][:, :n] for t in trs])))
        checks["golden " + g] = engine_case(
            f"engine {g} (golden traces, from their starts)", cm, src,
            engine_start(cm, trs), n, torch, E)
    return checks


def golden_peaks(label, y_fused, y_engine, lanes, drive, tone):
    """For each of ``lanes``: the sample of the window where the fused
    output (host, (L, T)) departs furthest from the engine's (same shape),
    and that distance over the engine's peak on the lane, in dB.  Returns
    {lane: (sample, dB)}."""
    out = {}
    for j, lane in enumerate(lanes):
        d = np.abs(np.asarray(y_fused[j], float) - np.asarray(y_engine[j],
                                                              float))
        s = int(np.argmax(d))
        db = 20 * np.log10(float(d[s]) / max(float(np.abs(
            y_engine[j]).max()), 1e-12) + 1e-300)
        out[lane] = (s, db)
        log(f"[{label}] lane {lane} (drive {drive[lane]:.3f}, tone "
            f"{tone[lane]:.3f}): fused against the engine over window 1 "
            f"peaks at sample {s} ({db:.1f} dB of the engine's peak)")
    return out


def golden_path(eng, fr_so, fr_full, traces, u, drive, tone, card, torch,
                F, E):
    """Phase 5j: the kernels on the 50-digit traces, each run from its
    trace's start.  The engine kernel (tol 1e-12) on every trace, the
    traces of one model and length as the lanes of one launch, each within
    ENGINE_PARITY_WORST_DB of its trace's peak; the main path's production
    build on the main path's seeded traces' lanes from their committed
    seeds, over the whole of window 1 (the trace's input, then the rest of
    the window, chained), fails and floored 0, each lane's dB against its
    trace printed and not gated, beside the engine's from the same start
    over the same window and the sample where the two depart furthest; the
    same build on each resumed trace from the engine's carry there (one
    launch each: their audio starts at different samples), reported; the
    full path's production build on ``superover.npz``
    within FULL_PARITY_WORST_DB.  The launch counts are set to 0 just
    before and read just after.  Returns (fused launches, engine
    launches)."""
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.utils.golden import (engine_start, fused_start,
                                             trace_db)
    F.LAUNCHES.clear()
    E.LAUNCHES.clear()
    dbs = {n: {} for n in traces}
    bad = []
    # the engine on every trace but the main path's seeded ones (below)
    batches = {}
    for name, (g, tr) in traces.items():
        if g != "main" or int(tr["start"]):
            batches.setdefault((g, tr["u"].shape), []).append(name)
    for (g, _), names in batches.items():
        cm = eng["golden " + g]
        trs = [traces[n][1] for n in names]
        y, _, info = cm.run(np.stack([t["u"] for t in trs]),
                            state=engine_start(cm, trs))
        y = y.cpu().numpy()
        for j, n in enumerate(names):
            dbs[n]["engine"] = trace_db(y[j], trs[j]["y"])
        log(f"[5j golden] engine kernel ({g}, {len(names)} lanes x "
            f"{trs[0]['u'].shape[1]} samples): " + ", ".join(
                f"{n} {dbs[n]['engine']:.1f} dB" for n in names)
            + f"; non-converged lane-samples {int((~info.converged).sum())}")
    # the main path's seeded lanes: fused from the committed seeds, engine
    # from the same point, window 1 in two chained calls (the trace's input,
    # then the window's rest)
    seeded = [n for n, (g, t) in traces.items()
              if g == "main" and not int(t["start"])]
    trs = [traces[n][1] for n in seeded]
    if any(not np.array_equal(t["u"][0], trs[0]["u"][0]) for t in trs):
        raise SmokeFailure("the seeded main-path traces' audio differs")
    lanes = [int(t["lane"]) for t in trs]
    T0 = trs[0]["u"].shape[1]
    lv = np.stack([t["u"][1:, 0] for t in trs])
    seed = load_steady_seed(os.path.join(HERE, ".steadyseed_cache.npz"),
                            SEED_TAG, fr_so, lanes=lanes)
    t0 = time.time()
    y1, st, i1 = fr_so.run(trs[0]["u"][:1], lv, state=seed, check=False)
    y2, _, i2 = fr_so.run(u[:, T0:], lv, state=st, check=False)
    torch.cuda.synchronize()
    t_fused = time.time() - t0
    y_f = torch.cat([y1, y2], dim=2)[:, 0].cpu().numpy()
    fails = int(i1.fails.sum() + i2.fails.sum())
    floored = int(i1.floored.sum() + i2.floored.sum())
    cm = eng["golden main"]
    t0 = time.time()
    ye1, es, c1 = cm.run_sweep(cm._as(trs[0]["u"][:1]), cm._as(lv), (1, 2),
                               state=engine_start(cm, trs))
    ye2, _, c2 = cm.run_sweep(cm._as(u[:, T0:]), cm._as(lv), (1, 2),
                              state=es)
    torch.cuda.synchronize()
    t_engine = time.time() - t0
    y_e = torch.cat([ye1, ye2], dim=2)[:, 0].cpu().numpy()
    nc = int((~c1.converged).sum() + (~c2.converged).sum())
    log(f"[5j golden] main path's seeded lanes {lanes}, window 1 "
        f"({y_f.shape[1]} samples): fused {t_fused:.1f}s, fails {fails}, "
        f"floored {floored}; engine {t_engine:.1f}s, non-converged "
        f"lane-samples {nc}")
    peaks = golden_peaks("5j golden", y_f, y_e, lanes, drive, tone)
    for j, (n, lane) in enumerate(zip(seeded, lanes)):
        dbs[n]["fused"] = trace_db(y_f[j, :T0], trs[j]["y"][0])
        dbs[n]["engine"] = trace_db(y_e[j, :T0], trs[j]["y"][0])
        s, db = peaks[lane]
        log(f"[5j golden] {n} (lane {lane}, drive {drive[lane]:.3f}, tone "
            f"{tone[lane]:.3f}), its {T0} samples: fused main path "
            f"{dbs[n]['fused']:.1f} dB, engine {dbs[n]['engine']:.1f} dB of "
            f"the trace's peak; over window 1 the two depart furthest at "
            f"sample {s} ({db:.1f} dB; "
            + ("inside the trace" if s < T0 else "after the trace") + ")")
    if fails or floored:
        bad.append(f"main path's build on the seeded lanes: fails {fails}, "
                   f"floored {floored}")
    # the resumed traces: the fused main build from the engine's carry,
    # one launch each (their audio starts at different samples)
    for n, (g, tr) in traces.items():
        if g != "main" or not int(tr["start"]):
            continue
        lane = int(tr["lane"])
        lv1 = tr["u"][1:, :1].T
        load_steady_seed(os.path.join(HERE, ".steadyseed_cache.npz"),
                         SEED_TAG, fr_so, lanes=[lane])
        y, _, info = fr_so.run(tr["u"][:1], lv1,
                               state=fused_start(fr_so, [tr], lv1),
                               check=False)
        dbs[n]["fused"] = trace_db(y[0, 0].cpu().numpy(), tr["y"][0])
        log(f"[5j golden] {n} (lane {lane}, from sample {int(tr['start'])} "
            f"of window 1, the engine's carry): fused main path "
            f"{dbs[n]['fused']:.1f} dB, engine {dbs[n]['engine']:.1f} dB; "
            f"fused fails {int(info.fails.sum())}, floored "
            f"{int(info.floored.sum())} (reported)")
    # the full path's build on superover.npz, from its steady state
    tr = traces["superover"][1]
    lv1 = np.ones((1, 1))
    y, _, info = fr_full.run(tr["u"], lv1, state=fused_start(fr_full, [tr],
                                                             lv1),
                             check=False)
    dbs["superover"]["fused full"] = trace_db(y[0].cpu().numpy(), tr["y"])
    log(f"[5j golden] superover ({tr['u'].shape[1]} samples from its steady "
        f"state): fused full path {dbs['superover']['fused full']:.1f} dB, "
        f"fails {int(info.fails.sum())}, floored {int(info.floored.sum())}")
    if dbs["superover"]["fused full"] > FULL_PARITY_WORST_DB:
        bad.append(f"fused full path on superover "
                   f"{dbs['superover']['fused full']:.1f} dB > "
                   f"{FULL_PARITY_WORST_DB}")
    for n, d in dbs.items():
        if d["engine"] > ENGINE_PARITY_WORST_DB:
            bad.append(f"engine on {n} {d['engine']:.1f} dB > "
                       f"{ENGINE_PARITY_WORST_DB}")
    fused_l, engine_l = dict(F.LAUNCHES), dict(E.LAUNCHES)
    log(f"[5j golden] (card: {card})")
    if bad:
        raise SmokeFailure(f"golden phase: {bad}")
    return fused_l, engine_l


def golden_launch_checks(eng, fr_so, fr_full, traces, fused_l, engine_l):
    """Fail unless the golden phase launched the main path's build twice
    and once for each resumed trace, the full path's once, and each golden
    engine once per batch of its traces (the main path's seeded ones in
    two chained calls), and nothing else."""
    resumed = sum(g == "main" and int(t["start"]) > 0
                  for g, t in traces.values())
    want_f = {fr_so.plan.cuda_name: 2 + resumed, fr_full.plan.cuda_name: 1}
    want_e = {}
    batches = {(g, t["u"].shape) for g, t in traces.values()
               if g != "main" or int(t["start"])}
    for g, _ in batches:
        key = eng["golden " + g].launch_key()
        want_e[key] = want_e.get(key, 0) + 1
    key = eng["golden main"].launch_key()
    want_e[key] = want_e.get(key, 0) + 2
    log(f"[6 launches] golden phase: fused {fused_l}, engine {engine_l}")
    if fused_l != want_f or engine_l != want_e:
        raise SmokeFailure(f"golden phase launches fused {fused_l}, engine "
                           f"{engine_l}; expected {want_f}, {want_e}")


def golden_entries(eng, checks, engine_l):
    """The "kernels" line's entries for the engine builds only the golden
    phase runs, with their phase-4 numbers and their golden launches."""
    out = []
    for g in GOLDEN_OWN_BUILDS:
        c = checks["golden " + g]
        out.append({"name": f"scan ({g}, float64, golden phase)",
                    "route": "cuda",
                    "source": "acme_tpu_torch/ops/csrc/scan.cu",
                    "replaces": "acme_tpu/engine.py:247-279",
                    "launches": engine_l.get(eng["golden " + g].launch_key(),
                                             0),
                    "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                    "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                    "bound_by": c["bound_by"], "library_ms": None})
    return out


def main():
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    from acme_tpu_torch import sweeps as S
    # the engine path's 4096-lane steady seeds (minutes of host numpy) and
    # the 18 parity lanes' seeds in a batch of their own, in worker
    # processes from the start; the pool is terminated on every exit
    seed_pool = multiprocessing.get_context("spawn").Pool(2)
    # the golden phase's own engine builds (the un-decomposed pots Super
    # Over's is the run's longest nvcc) in threads of their own, started
    # after phase 2's builds, on the cores phase 4's host-bound checks
    # leave idle, and waited for where phase 4 first needs them
    golden_pool = ThreadPoolExecutor(len(GOLDEN_OWN_BUILDS))
    try:
        seeds = (seed_pool.apply_async(engine_seeds),
                 seed_pool.apply_async(engine_seeds, (S.select_parity_lanes(
                     L_MAIN, 16, S.stress_lanes("pots", L_MAIN)),)))
        return run_all(t_start, torch, seeds, golden_pool)
    finally:
        seed_pool.terminate()
        seed_pool.join()
        golden_pool.shutdown(cancel_futures=True)


def run_all(t_start, torch, seed_jobs, golden_pool):
    """The whole run (``main``), the engine's seeds computing in
    ``seed_jobs``, the golden phase's own engine builds in
    ``golden_pool``."""
    from acme_tpu_torch import FusedRunner, ablate
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.models import birdie_model, diodeclipper_model
    from acme_tpu_torch.ops import build as B
    from acme_tpu_torch.ops import fused as F
    from acme_tpu_torch.ops.emit import model_header, op_counts
    from acme_tpu_torch import engine as E

    dev = torch.device("cuda", 0)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    prod = S.PRODUCTION

    t0 = time.time()
    try:
        nvcc_v = subprocess.run([B._nvcc(), "--version"], capture_output=True,
                                text=True).stdout.strip().splitlines()[-1]
    except (OSError, RuntimeError) as e:
        raise SmokeFailure(f"nvcc unavailable: {e}")
    log(f"[1 device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | {nvcc_v} | python "
        f"{sys.version.split()[0]} ({time.time() - t0:.1f}s)")

    # 3 (prepared first: the builds need the prepared runners)
    t0 = time.time()
    pre_specs = [S.preset_spec(d, t, FS) for d, t in S.PRESETS]
    m_so, m_lvl, m_full, m_pots, *m_pre = S.build_models(
        [S.model_spec("pots", "chain", FS), S.model_spec("level", "chain", FS),
         S.model_spec("level", "full", FS), S.model_spec("pots", "full", FS)]
        + pre_specs)
    log(f"[3 model] {4 + len(m_pre)} Super Over models built in "
        f"{time.time() - t0:.1f}s (worker processes)")
    # the models as built, for the runners of phases 5e, 5f and 5j (a
    # runner's centering runs the model's stateful host solvers)
    m_so_built, m_lvl_built = copy.deepcopy(m_so), copy.deepcopy(m_lvl)
    m_full_built = copy.deepcopy(m_full)
    traces = golden_traces()
    t0 = time.time()
    fr_so = FusedRunner(m_so, lane_input_idx=(1, 2), device=dev,
                        powerup="steady", **prod)
    fr_clip = FusedRunner(diodeclipper_model(), device=dev, **prod)
    fr_bird = FusedRunner(birdie_model(), lane_input_idx=(1,), device=dev,
                          **prod)
    _, drive, tone, lane_values, _ = S.lane_grid("pots", L_MAIN)
    seed = load_steady_seed(os.path.join(HERE, ".steadyseed_cache.npz"),
                            SEED_TAG, fr_so)
    describe("Super Over (pots, + clipper, birdie, seeds)", m_so, fr_so,
             time.time() - t0)
    cold = dict(device=dev, powerup="safe", powerup_samples=POWERUP_SAMPLES,
                **prod)
    t0 = time.time()
    levels, _, _, lv_level, lv_cfg = S.lane_grid("level", L_MAIN)
    fr_lvl = FusedRunner(m_lvl, **cold, **lv_cfg)
    describe("level Super Over", m_lvl, fr_lvl, time.time() - t0)
    t0 = time.time()
    pre_levels, pre_drive, pre_tone, lv_pre, pre_cfg = S.lane_grid(
        "presets", L_MAIN)
    fr_pre = FusedRunner(m_pre, **cold, **pre_cfg)
    describe(f"{len(m_pre)} presets {S.PRESETS}", m_pre[0], fr_pre,
             time.time() - t0)
    if fr_pre.nvar == 0:
        raise SmokeFailure("the presets share every coefficient: the "
                           "per-lane tables would not be read")
    t0 = time.time()
    fr_full = FusedRunner(m_full, **cold, **lv_cfg)
    describe("un-decomposed Super Over (full)", m_full, fr_full,
             time.time() - t0)
    t0 = time.time()
    eng = engine_runners(copy.deepcopy(m_so_built), copy.deepcopy(m_lvl_built),
                         dev, torch)
    eng.update(golden_engines(m_full_built, m_pots, copy.deepcopy(m_so_built),
                              dev))
    log(f"[3 model] engine runners {list(eng)} in {time.time() - t0:.1f}s; "
        f"{len(traces)} golden traces")
    golden_own = {k: eng[k] for k in ("golden " + g
                                      for g in GOLDEN_OWN_BUILDS)}
    eng_shared = {k: cm for k, cm in eng.items() if k not in golden_own}

    t0 = time.time()
    runners = {"clipper": fr_clip, "birdie": fr_bird, "superover": fr_so}
    for n, fr in (("level", fr_lvl), ("presets", fr_pre), ("full", fr_full)):
        runners[n] = fr
        runners[n + " powerup"] = fr._powerup_runner()
    T = FS
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    # each preset's lowest-level and highest-level lane
    n_pre = len(m_pre)
    pre_lanes = list(range(n_pre)) + list(range(L_MAIN - n_pre, L_MAIN))
    # one nvcc per distinct header: equal configurations share a build
    builds = {}

    def start(ex, name, r):
        key = header_key(r.plan, model_header)
        if key not in builds:
            builds[key] = (name, ex.submit(B.compile_library, r.plan))
        return key

    # spawned, not forked: this process holds a CUDA context
    with ThreadPoolExecutor(BUILD_WORKERS) as ex, ProcessPoolExecutor(
            n_pre, mp_context=multiprocessing.get_context("spawn")) as pool:
        keys = {n: start(ex, n, r) for n, r in runners.items()}
        eng_builds = start_engine_builds(ex, eng_shared, B)
        # while nvcc runs: the presets path's float64 references, and the
        # runners of the step configurations, each build started as its
        # runner is ready
        t1 = time.time()
        pre_refs = host_references(pool, pre_specs, pre_levels, pre_lanes,
                                   u[:, :PRESETS_REF_SAMPLES])
        # one runner per row of the ablation (base first), each on its own
        # copy of the model as built: equal copies give equal coefficients,
        # so equal configurations get equal headers and share a build
        rows, abl_skipped = ablate.order(ablate.ROWS)
        abl = {}
        for name in rows:
            abl[name] = FusedRunner(copy.deepcopy(m_lvl_built),
                                    lane_scale_idx=(0,), device=dev,
                                    **ablate.row_kwargs(name))
            runners["ablation " + name] = abl[name]
            keys["ablation " + name] = start(ex, "ablation " + name,
                                             abl[name])
        abl_pu = ablate.base_runner(copy.deepcopy(m_lvl_built), dev)
        runners["ablation base powerup"] = abl_pu._powerup_runner()
        keys["ablation base powerup"] = start(
            ex, "ablation base powerup", runners["ablation base powerup"])
        tiers, tier_seeds = {}, {}
        for name, over in S.VERDICT_TIERS.items():
            tiers[name] = FusedRunner(copy.deepcopy(m_so_built),
                                      lane_input_idx=(1, 2), device=dev,
                                      powerup="steady", **{**prod, **over})
            tier_seeds[name] = load_steady_seed(
                os.path.join(HERE, ".steadyseed_cache.npz"), SEED_TAG,
                tiers[name])
            runners["tier " + name] = tiers[name]
            keys["tier " + name] = start(ex, "tier " + name, tiers[name])
        # the groups path (docs/tpu.md's quick-start with its first
        # production knob, JAX defaults otherwise: lane groups of 2048) and
        # its merge twin, on copies of the main path's model as built
        groups, group_seeds = {}, {}
        for mode in ("group", "merge"):
            groups[mode] = FusedRunner(copy.deepcopy(m_so_built),
                                       lane_input_idx=(1, 2), device=dev,
                                       fast_iters=1, fast_verify=mode)
            group_seeds[mode] = load_steady_seed(
                os.path.join(HERE, ".steadyseed_cache.npz"), SEED_TAG,
                groups[mode])
            runners["groups " + mode] = groups[mode]
            keys["groups " + mode] = start(ex, "groups " + mode,
                                           groups[mode])
        # the mesh path: the main path's and the groups path's runners over
        # a mesh that names the card twice, on copies of the main path's
        # model as built, so their headers (and builds) are those paths'
        meshed, mesh_seeds = {}, {}
        for name, kw in (("main", dict(powerup="steady", **prod)),
                         ("groups", dict(fast_iters=1))):
            meshed[name] = FusedRunner(copy.deepcopy(m_so_built),
                                       lane_input_idx=(1, 2), device=dev,
                                       mesh=(dev, dev), **kw)
            mesh_seeds[name] = load_steady_seed(
                os.path.join(HERE, ".steadyseed_cache.npz"), SEED_TAG,
                meshed[name])
            runners["mesh " + name] = meshed[name]
            keys["mesh " + name] = start(ex, "mesh " + name, meshed[name])
        t_runners = time.time() - t1
        pre_refs = pre_refs()
        t_refs = time.time() - t1
        libs = {key: f.result() for key, (_, f) in builds.items()}
    for key, path in libs.items():
        name = builds[key][0]
        secs, out = B.build_log(path)
        # the entry's registers and frame, and any function that spills
        regs = ptxas_lines(out)
        # without recursion no call chain needs more stack than the sum
        # of every function's frame: it must fit the limit the launch sets
        frames = sum(int(b) for b in re.findall(r"(\d+) bytes stack frame",
                                                out))
        shared = [n for n, k in keys.items() if k == key]
        log(f"[2 build] {' = '.join(shared)} "
            f"({runners[name].plan.kernel_name}): nvcc {secs:.1f}s -> "
            f"{os.path.basename(path)}; stack frames sum to {frames} of the "
            f"launch's {B.STACK_BYTES} bytes")
        for ln in regs:
            log(f"    ptxas: {ln}")
        if frames > B.STACK_BYTES:
            raise SmokeFailure(f"{name}: ptxas stack frames sum to {frames} "
                               f"bytes, over the launch's {B.STACK_BYTES}")
        if key in {keys[n] for n in FRAMELESS_BUILDS}:
            # a frameless build: its calls and SASS, and its gate
            for ln in fused_build_lines(path, out):
                log(f"    {ln}")
            frame_gate(name, out)
    for r in runners.values():
        B.load_kernel(r.plan)
    log_engine_builds(eng_builds, eng_shared, B)
    log(f"[2 build] {len(libs)} builds for {len(runners)} runners, total "
        f"{time.time() - t0:.1f}s (parallel; beside them "
        f"{len(abl) + 1 + len(tiers) + len(groups) + len(meshed)} "
        "runners of the step "
        "configurations "
        f"prepared in {t_runners:.1f}s, and {len(pre_lanes)} host "
        f"references x {PRESETS_REF_SAMPLES} samples done at "
        f"{t_refs:.1f}s)")
    for name in abl_skipped:
        log(f"[2 build] ablation {name}: skipped ({ablate.SKIPPED[name]})")
    golden_builds = start_engine_builds(golden_pool, golden_own, B)

    t0 = time.time()
    log("[4 kernel vs plain] (card: " + card + ")")
    Tc = 256
    uc = (1.0 * np.sin(2 * np.pi * 1000 / FS * np.arange(Tc)))[None, :]
    compare_case("clipper", fr_clip, uc, np.zeros((128, 0)),
                 fr_clip.initial_state(128), torch, F, op_counts)
    uc = (0.3 * np.sin(2 * np.pi * 1000 / FS
                       * np.arange(POTS_CHECK_SAMPLES)))[None, :]
    vols = np.linspace(0.05, 0.95, 128)[:, None]
    compare_case("birdie", fr_bird, uc, vols, fr_bird.initial_state(128),
                 torch, F, op_counts)
    checks = {}
    checks["superover"], _ = compare_case(
        "superover", fr_so, u[:, :POTS_CHECK_SAMPLES], lane_values, seed,
        torch, F, op_counts)
    Tc = 64
    powered = {}
    for n, fr, lv, t in (("level", fr_lvl, lv_level, Tc),
                         ("presets", fr_pre, lv_pre, Tc),
                         ("full", fr_full, lv_level, FULL_CHECK_SAMPLES)):
        pr = runners[n + " powerup"]
        checks[n + " powerup"], powered[n] = compare_case(
            n + " powerup", pr, u[:, :t], lv, pr.initial_state(L_MAIN),
            torch, F, op_counts)
        checks[n], _ = compare_case(n, fr, u[:, t:2 * t], lv, powered[n],
                                    torch, F, op_counts)
    log(f"[4 kernel vs plain] {time.time() - t0:.1f}s")
    t0 = time.time()
    # the step configurations' builds, one check each: the ablation's as
    # the level model's (its power-up build from cold), the verdict tiers
    # at the main path's lanes from the seeds
    checked = {keys["level"]: "level", keys["level powerup"]: "level powerup"}
    for n in list(keys):
        if not n.startswith(("ablation ", "tier ")) or keys[n] in checked:
            continue
        checked[keys[n]] = n
        fr = runners[n]
        if n.startswith("tier "):
            args = (u[:, :TIER_CHECK_SAMPLES], lane_values,
                    tier_seeds[n[len("tier "):]])
        elif n.endswith(" powerup"):
            args = (u[:, :Tc], lv_level, fr.initial_state(L_MAIN))
        else:
            args = (u[:, Tc:2 * Tc], lv_level, powered["level"])
        shared = [m for m, k in keys.items() if k == keys[n]]
        checks[n], _ = compare_case(" = ".join(shared), fr, *args, torch, F,
                                    op_counts)
    log(f"[4 kernel vs plain] step configurations {time.time() - t0:.1f}s")
    t0 = time.time()
    group_rows = group_checks(groups["group"], groups["merge"],
                              u[:, :TIER_CHECK_SAMPLES], lane_values,
                              group_seeds["group"], torch, F, op_counts)
    checks["groups group"] = group_rows["group"]
    checks["groups merge"] = group_rows["merge"]
    log(f"[4 kernel vs plain] lane groups {time.time() - t0:.1f}s")
    t0 = time.time()
    eng_checks = engine_checks(eng, u, levels, torch, E)
    t1 = time.time()
    log_engine_builds(golden_builds, golden_own, B)
    log(f"[2 build] the golden phase's {len(golden_builds)} engine builds "
        f"(since phase 4 began), waited {time.time() - t1:.1f}s here")
    eng_checks.update(golden_checks(eng, traces, torch, E))
    log(f"[4 kernel vs plain] engine builds {time.time() - t0:.1f}s")

    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    # every lane's windows 1 and 7 kept, for phase 5i's whole-grid score
    fused_main = drive_path(
        "5 main path", fr_so, u, lane_values, seed, WINDOWS,
        np.arange(L_MAIN), card, torch, F, op_counts, hold=MESH_WINDOWS)
    y_pw, y_st, main_launches, _, main_rows = fused_main
    fused_main = (y_pw, y_st)
    main_rows = main_rows[:MESH_WINDOWS]
    score("5 main path", lanes,
          [f"drive {drive[i]:.3f}, tone {tone[i]:.3f}" for i in lanes],
          y_pw[lanes], y_st[lanes],
          [S.ref_key("pots", "chain", FS, T, MAIN_REPS, 1.0, drive[i],
                     tone[i], powerup="steady") for i in lanes],
          WINDOWS, PARITY_WORST_DB, PARITY_MEDIAN_DB)
    log(f"[5 main path] {time.time() - t0:.1f}s")

    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("level",
                                                             L_MAIN))
    y_pw, y_st, level_launches, counts, _ = cold_path(
        "5b level path", fr_lvl, u, lv_level, lanes, card, torch, F,
        op_counts)
    steady_windows_clean("5b level path", counts)
    score("5b level path", lanes, [f"level {levels[i]:.4f}" for i in lanes],
          y_pw, y_st,
          [S.ref_key("level", "chain", FS, T, LEVEL_REPS, levels[i], 1.0,
                     1.0) for i in lanes],
          LEVEL_WINDOWS, LEVEL_PARITY_WORST_DB)
    log(f"[5b level path] {time.time() - t0:.1f}s")

    t0 = time.time()
    y_pw, _, presets_launches, counts, _ = cold_path(
        "5c presets path", fr_pre, u, lv_pre, pre_lanes, card, torch, F,
        op_counts)
    steady_windows_clean("5c presets path", counts)
    score_presets("5c presets path", pre_lanes, pre_levels, pre_drive,
                  pre_tone, y_pw, pre_refs, POWERUP_SAMPLES,
                  PRESETS_PARITY_WORST_DB)
    log(f"[5c presets path] {time.time() - t0:.1f}s")

    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 8, [])
    y_pw, y_st, full_launches, counts, _ = cold_path(
        "5d full path", fr_full, u, lv_level, lanes, card, torch, F,
        op_counts)
    log(f"[5d full path] (fails, floored) by window: {counts}")
    score("5d full path", lanes, [f"level {levels[i]:.4f}" for i in lanes],
          y_pw, y_st,
          [S.ref_key("level", "full", FS, T, LEVEL_REPS, levels[i], 1.0,
                     1.0) for i in lanes],
          LEVEL_WINDOWS, FULL_PARITY_WORST_DB)
    log(f"[5d full path] {time.time() - t0:.1f}s")


    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("level",
                                                             L_MAIN))
    abl_out, ablation_launches = ablation_path(
        "5e ablation path", abl, abl_pu, u, lv_level, lanes,
        [S.ref_key("level", "chain", FS, T, LEVEL_REPS, levels[i], 1.0, 1.0)
         for i in lanes], card, torch, F, ablate, op_counts)
    for name in abl_skipped:
        log(f"[5e ablation path] {name}: skipped ({ablate.SKIPPED[name]})")
    log(f"[5e ablation path] {time.time() - t0:.1f}s")

    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    tier_launches = {}
    for name, fr in tiers.items():
        label = f"5f verdict tier {name}"
        y_pw, y_st, tier_launches[name], _, _ = drive_path(
            label, fr, u, lane_values, tier_seeds[name], WINDOWS, lanes,
            card, torch, F, op_counts)
        score(label, lanes,
              [f"drive {drive[i]:.3f}, tone {tone[i]:.3f}" for i in lanes],
              y_pw, y_st,
              [S.ref_key("pots", "chain", FS, T, MAIN_REPS, 1.0, drive[i],
                         tone[i], powerup="steady") for i in lanes],
              WINDOWS, PARITY_WORST_DB, PARITY_MEDIAN_DB)
    log(f"[5f verdict tiers] {time.time() - t0:.1f}s")

    t0 = time.time()
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    groups_launches, twin_launches, group_row = groups_path(
        groups["group"], groups["merge"], u, lane_values,
        (group_seeds["group"], group_seeds["merge"]), lanes,
        [f"drive {drive[i]:.3f}, tone {tone[i]:.3f}" for i in lanes],
        [S.ref_key("pots", "chain", FS, T, MAIN_REPS, 1.0, drive[i],
                   tone[i], powerup="steady") for i in lanes],
        card, torch, F, op_counts)
    log(f"[5g groups path] {time.time() - t0:.1f}s")

    t0 = time.time()
    for name, fr in (("main", fr_so), ("groups", groups["group"])):
        if meshed[name].plan.cuda_name != fr.plan.cuda_name:
            raise SmokeFailure(f"the mesh {name} path has a build of its "
                               "own: its header differs from its path's")
    mesh_path(meshed, mesh_seeds, fr_so, groups["group"], main_rows,
              group_row, u, lane_values, card, dev, torch, F, op_counts)
    del main_rows, group_row
    log(f"[5h mesh] {time.time() - t0:.1f}s")

    eng_launches = engine_tail(eng, eng_checks, seed_jobs, u, lane_values,
                               drive, tone, levels, fused_main, card, torch,
                               E, S)
    del fused_main, y_pw, y_st

    t0 = time.time()
    golden_f, golden_e = golden_path(eng, fr_so, fr_full, traces, u, drive,
                                     tone, card, torch, F, E)
    golden_launch_checks(eng, fr_so, fr_full, traces, golden_f, golden_e)
    log(f"[5j golden] {time.time() - t0:.1f}s")

    # one entry per build: (name, runner key, the launch counts of the
    # path it runs on, how many of them are this build's)
    lib_of = {n: runners[n].plan.cuda_name for n in runners}
    entries = [("fused_sweep (Super Over pots, main path)", "superover",
                main_launches, WINDOWS)]
    for n, path, launches in (("level", "level path", level_launches),
                              ("presets", "presets path", presets_launches),
                              ("full", "full path", full_launches)):
        also = " = ablation cf2" if n == "level" else ""
        entries.append((f"fused_sweep ({n} Super Over, {path}{also})", n,
                        launches, LEVEL_WINDOWS))
        entries.append((f"fused_sweep_powerup ({n} Super Over, {path})",
                        n + " powerup", launches, 1))
    if len({lib_of[k] for _, k, _, _ in entries}) != len(entries):
        raise SmokeFailure(f"the paths' builds share a library: {lib_of}")
    # the ablation path: a warm window and ABLATION_REPS timed ones per
    # row; the base's build also runs the power-up window's production
    # part, its power-up build the rest
    rows_of = {}
    for name in abl:
        rows_of.setdefault(lib_of["ablation " + name], []).append(name)
    abl_expected = {lib: (1 + ABLATION_REPS) * len(rows)
                    for lib, rows in rows_of.items()}
    abl_expected[lib_of["ablation base"]] += 1
    abl_expected[lib_of["ablation base powerup"]] = 1
    for lib, rows in rows_of.items():
        if lib == lib_of["level"]:
            continue
        entries.append((f"fused_sweep (level Super Over, ablation "
                        f"{' = '.join(rows)})", "ablation " + rows[0],
                        ablation_launches, abl_expected[lib]))
    entries.append(("fused_sweep_powerup (level Super Over, ablation base)",
                    "ablation base powerup", ablation_launches, 1))
    for name in tiers:
        entries.append((f"fused_sweep (Super Over pots, verdict tier "
                        f"{name})", "tier " + name, tier_launches[name],
                        WINDOWS))
    entries.append(("fused_sweep_group (Super Over pots, groups path)",
                    "groups group", groups_launches, GROUPS_WINDOWS))
    entries.append(("fused_sweep (Super Over pots, groups path's merge "
                    "twin)", "groups merge", twin_launches, 1))
    # one launch per window; a cold path's window 1 adds the power-up
    for path, launches, keys_ in (
            ("main path", main_launches, ("superover",)),
            ("level path", level_launches, ("level", "level powerup")),
            ("presets path", presets_launches,
             ("presets", "presets powerup")),
            ("full path", full_launches, ("full", "full powerup"))):
        expected = {lib_of[k]: n for _, k, _, n in entries if k in keys_}
        log(f"[6 launches] {path}: "
            f"{ {k: launches.get(lib_of[k], 0) for k in keys_} }")
        if launches != expected:
            raise SmokeFailure(f"{path} launches {launches}, expected "
                               f"{expected}")
    by_rows = {" = ".join(rows_of.get(lib, ["base powerup"])): n
               for lib, n in ablation_launches.items()}
    log(f"[6 launches] ablation path: {by_rows}")
    if ablation_launches != abl_expected:
        raise SmokeFailure(f"ablation path launches {ablation_launches}, "
                           f"expected {abl_expected}")
    for name in tiers:
        expected = {lib_of["tier " + name]: WINDOWS}
        log(f"[6 launches] verdict tier {name}: {tier_launches[name]}")
        if tier_launches[name] != expected:
            raise SmokeFailure(f"verdict tier {name} launches "
                               f"{tier_launches[name]}, expected {expected}")
    for path, launches, key, n in (
            ("groups path", groups_launches, "groups group",
             GROUPS_WINDOWS),
            ("groups path's merge twin", twin_launches, "groups merge", 1)):
        expected = {lib_of[key]: n}
        log(f"[6 launches] {path}: {launches}")
        if launches != expected:
            raise SmokeFailure(f"{path} launches {launches}, expected "
                               f"{expected}")

    kernels = []
    for name, key, launches, _ in entries:
        case = checks[key] if key in checks else checks[
            next(n for n in checks if n in runners
                 and lib_of[n] == lib_of[key])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "acme_tpu_torch/ops/csrc/fused.cu",
            "replaces": "acme_tpu/ops/fused.py:2483",
            "launches": launches[lib_of[key]],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None})
    kernels += engine_entries(eng, eng_checks, eng_launches)
    kernels += golden_entries(eng, eng_checks, golden_e)
    log(f"[total] {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))



def engine_tail(eng, checks, seed_jobs, u, lane_values, drive, tone, levels,
                fused, card, torch, E, S):
    """The engine's phases that need the seeds: phase 4's rows for the main
    path's model from the seeds and its split over (cuda:0, cuda:0), then
    phase 5i (``engine_path``) and the clipper builds' windows.  Adds the
    main row to ``checks``; returns the launch counts of each drive."""
    t0 = time.time()
    seeds = seed_jobs[0].get()
    seeds18 = seed_jobs[1].get()
    seed_state = engine_state(seeds, eng["main"].device, torch)
    log(f"[5i engine path] steady seeds of {L_MAIN} lanes (host, a worker "
        f"process since phase 1): {seeds[2]:.1f}s of host time; the 18 "
        f"parity lanes alone: {seeds18[2]:.1f}s; waited {time.time() - t0:.1f}"
        "s here")
    t0 = time.time()
    log(f"[4 kernel vs plain] engine builds from the seeds (card: {card})")
    cm = eng["main"]
    n = ENGINE_CHECK_SAMPLES
    checks["main"] = engine_case(
        "engine Super Over (seeds)", cm,
        cm._sweep_src(cm._as(u[:, :n]), cm._as(lane_values), (1, 2)),
        seed_state, n, torch, E)
    engine_split(cm, u[:, :n], lane_values, seed_state, card, torch, E)
    log(f"[4 kernel vs plain] engine from the seeds {time.time() - t0:.1f}s")
    t0 = time.time()
    main_l, level_l, _ = engine_path(eng, seed_state, seeds18, u,
                                     lane_values, drive, tone, levels, fused,
                                     card, torch, E, S)
    launches = engine_clipper_runs(eng, torch, E)
    launches.update(main=main_l, level=level_l)
    log(f"[5i engine path] {time.time() - t0:.1f}s")
    engine_launch_checks(eng, launches, {
        "main": WINDOWS, "level": 1, "clipper": 1, "clipper f32": 1,
        "four clippers": 1})
    return launches


def engine_main():
    """``--engine``: phases 1-3 for the engine alone (the device, the main
    path's and the level sweep's models, the engine builds), phase 4's
    engine rows and phase 5i without the fused comparison; no result
    line."""
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    from acme_tpu_torch import sweeps as S
    seed_pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        seeds = (seed_pool.apply_async(engine_seeds),
                 seed_pool.apply_async(engine_seeds, (S.select_parity_lanes(
                     L_MAIN, 16, S.stress_lanes("pots", L_MAIN)),)))
        from acme_tpu_torch import engine as E
        from acme_tpu_torch.ops import build as B
        dev = torch.device("cuda", 0)
        card = smi()
        log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
            f"{card} | torch {torch.__version__} CUDA {torch.version.cuda}")
        t0 = time.time()
        m_so, m_lvl = S.build_models([S.model_spec("pots", "chain", FS),
                                      S.model_spec("level", "chain", FS)])
        eng = engine_runners(m_so, m_lvl, dev, torch)
        log(f"[3 model] main and level Super Over, engine runners "
            f"{list(eng)} in {time.time() - t0:.1f}s")
        t0 = time.time()
        with ThreadPoolExecutor(BUILD_WORKERS) as ex:
            builds = start_engine_builds(ex, eng, B)
            log_engine_builds(builds, eng, B)
        log(f"[2 build] {len(builds)} engine builds in "
            f"{time.time() - t0:.1f}s")
        _, drive, tone, lane_values, _ = S.lane_grid("pots", L_MAIN)
        levels = S.lane_grid("level", L_MAIN)[0]
        u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
        t0 = time.time()
        log(f"[4 kernel vs plain] (card: {card})")
        checks = engine_checks(eng, u, levels, torch, E)
        log(f"[4 kernel vs plain] engine builds {time.time() - t0:.1f}s")
        engine_tail(eng, checks, seeds, u, lane_values, drive, tone, levels,
                    None, card, torch, E, S)
        log(f"[total] {time.time() - t_start:.1f}s")
    finally:
        seed_pool.terminate()
        seed_pool.join()

def golden_main():
    """``--golden``: phase 5j alone, with what it needs: the device, its
    models (the main path's and the full path's Super Overs, the pots
    Super Over un-decomposed, the small circuits), the main and full
    paths' production builds and the golden engines' builds, phase 4's
    rows for the engine builds only it runs; no result line."""
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    from acme_tpu_torch import FusedRunner
    from acme_tpu_torch import engine as E
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.ops import build as B
    from acme_tpu_torch.ops import fused as F
    dev = torch.device("cuda", 0)
    card = smi()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.time()
    traces = golden_traces()
    m_so, m_full, m_pots = S.build_models(
        [S.model_spec("pots", "chain", FS), S.model_spec("level", "full", FS),
         S.model_spec("pots", "full", FS)])
    eng = golden_engines(copy.deepcopy(m_full), m_pots, copy.deepcopy(m_so),
                         dev)
    prod = S.PRODUCTION
    fr_so = FusedRunner(m_so, lane_input_idx=(1, 2), device=dev,
                        powerup="steady", **prod)
    fr_full = FusedRunner(m_full, device=dev, powerup="safe",
                          powerup_samples=POWERUP_SAMPLES, **prod,
                          **S.lane_grid("level", L_MAIN)[4])
    log(f"[3 model] the golden traces' models, runners and engines "
        f"{list(eng)} in {time.time() - t0:.1f}s; {len(traces)} traces")
    t0 = time.time()
    with ThreadPoolExecutor(BUILD_WORKERS) as ex:
        fused = [ex.submit(B.compile_library, r.plan) for r in (fr_so,
                                                                 fr_full)]
        builds = start_engine_builds(ex, eng, B)
        for f in fused:
            f.result()
        log_engine_builds(builds, eng, B)
    for r in (fr_so, fr_full):
        B.load_kernel(r.plan)
    log(f"[2 build] 2 fused and {len(builds)} engine builds in "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    log(f"[4 kernel vs plain] (card: {card})")
    golden_checks(eng, traces, torch, E)
    log(f"[4 kernel vs plain] golden engine builds {time.time() - t0:.1f}s")
    _, drive, tone, _, _ = S.lane_grid("pots", L_MAIN)
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
    t0 = time.time()
    fused_l, engine_l = golden_path(eng, fr_so, fr_full, traces, u, drive,
                                    tone, card, torch, F, E)
    golden_launch_checks(eng, fr_so, fr_full, traces, fused_l, engine_l)
    log(f"[5j golden] {time.time() - t0:.1f}s")
    log(f"[total] {time.time() - t_start:.1f}s")


def sass_stats(path):
    """{kernel entry: (instructions, LDL, STL)} of the SASS in library
    ``path`` (``cuobjdump -sass``; {} without it): the instruction stream
    each kernel's warps fetch, 16 bytes an instruction, and its loads and
    stores of the thread's local memory (its stack frame and spills)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True, timeout=300).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    stats = {}
    for part in re.split(r"Function : ", out)[1:]:
        name = part.split(None, 1)[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?\w+\s+)?([A-Z0-9_]+)",
                         part)
        stats[name] = (len(ops), ops.count("LDL"), ops.count("STL"))
    return stats


def sass_sizes(path):
    """{kernel entry: instructions} of the SASS in library ``path``."""
    return {k: v[0] for k, v in sass_stats(path).items()}


def sass_size(path):
    """(instructions, bytes, LDL, STL) of all the SASS in library
    ``path``."""
    rows = sass_stats(path).values()
    n = sum(r[0] for r in rows)
    return n, 16 * n, sum(r[1] for r in rows), sum(r[2] for r in rows)


def ptxas_calls(out):
    """The functions a build's ptxas -v log lists beside its kernel
    entries: those the inliner left as calls (demangled where c++filt
    is there)."""
    entries = set(re.findall(r"Compiling entry function '(\S+)'", out))
    names = [n for n in dict.fromkeys(
        re.findall(r"Function properties for (\S+)", out))
        if n not in entries]
    tool = shutil.which("c++filt")
    if names and tool:
        try:
            names = subprocess.run([tool] + names, capture_output=True,
                                   text=True, timeout=60).stdout.split("\n")
            names = [n for n in names if n]
        except (OSError, subprocess.SubprocessError):
            pass
    return names


def ptxas_lines(out):
    """ptxas's entry numbers and every function with a frame or spills,
    from a build's log."""
    return [ln.strip() for ln in out.splitlines()
            if "Used" in ln or ("stack frame" in ln and not ln.strip()
                                .startswith("0 bytes stack frame, 0 bytes"))]


def spill_sites(plan, B):
    """The SASS loads and stores of local memory (LDL, STL) of ``plan``'s
    build by source line: the build compiled once more with ``-lineinfo``
    into a cubin (kept beside its library), read with ``nvdisasm -gi``;
    lines counted by the innermost source line and by the chain of
    step.cuh and linsolve.cuh lines inlined into it, the 20 largest of
    each."""
    from acme_tpu_torch.ops.emit import write_header
    lib = B.compile_library(plan)
    cubin = lib + ".lineinfo.cubin"
    if not os.path.exists(cubin):
        flags = [f for f in B.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        tmp = f"{cubin}.{os.getpid()}.tmp"
        subprocess.run([B._nvcc()] + flags + [
            "-lineinfo", "-cubin", "-I", B.CSRC, "-include",
            write_header(plan, os.path.dirname(lib)), "-o", tmp,
            os.path.join(B.CSRC, B.SOURCES[-1])], capture_output=True,
            check=True)
        os.replace(tmp, cubin)
    tool = shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm"
    sass = subprocess.run([tool, "-gi", "-c", cubin], capture_output=True,
                          text=True, check=True).stdout
    chain, after_op = [], True
    inner, chains = {}, {}
    for ln in sass.splitlines():
        m = re.search(r'//## File "([^"]+)", line (\d+)', ln)
        if m:
            # an instruction's inlining chain, innermost line first
            chain = [] if after_op else chain
            chain.append(f"{os.path.basename(m.group(1))}:{m.group(2)}")
            after_op = False
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?\w+\s+)?([A-Z0-9_]+)", ln)
        if not m:
            continue
        after_op = True
        if m.group(1) in ("LDL", "STL"):
            k = m.group(1), chain[0] if chain else "?"
            inner[k] = inner.get(k, 0) + 1
            k = m.group(1), " < ".join(
                [c for c in chain if c.startswith(("step", "linsolve"))][:4])
            chains[k] = chains.get(k, 0) + 1
    lines = []
    for title, c in (("innermost line", inner),
                     ("step.cuh / linsolve.cuh chain", chains)):
        lines.append(f"local memory by {title}:")
        lines += [f"  {op} {k:5d}  {where}" for (op, where), k in
                  sorted(c.items(), key=lambda kv: -kv[1])[:20]]
    return lines


def fused_build_lines(path, out, plan=None, B=None):
    """The lines logged for a fused build beside ptxas's: the functions
    its log lists as calls, and its SASS (instructions, local-memory loads
    and stores); with its ``plan``, where it loads or stores local memory
    (``spill_sites``)."""
    calls = ptxas_calls(out)
    n, nbytes, ldl, stl = sass_size(path)
    lines = [f"calls: {', '.join(calls) if calls else 'none'}",
             f"SASS {n} instructions ({nbytes / 1024:.0f} KiB), {ldl} LDL, "
             f"{stl} STL"]
    if plan is not None and ldl + stl:
        lines += spill_sites(plan, B)
    return lines


def frame_gate(name, out):
    """Fail unless a frameless build's (FRAMELESS_BUILDS) kernel entry
    keeps within FRAME_BYTES of stack frame and has no spill stores
    (ptxas's log ``out``)."""
    rows = ptxas_entries(out)
    if not rows:
        raise SmokeFailure(f"{name}: no ptxas report for its kernel entry")
    for entry, regs, frame, st, ld in rows:
        if frame > FRAME_BYTES or st > 0:
            raise SmokeFailure(
                f"{name}: ptxas reports {frame} bytes of stack frame and "
                f"{st} bytes of spill stores for {entry} (at most "
                f"{FRAME_BYTES} and none)")
        log(f"[2 build] {name}: the entry within its gate: {regs} "
            f"registers, {frame} bytes stack frame (at most {FRAME_BYTES}), "
            f"{st} bytes spill stores, {ld} bytes spill loads")


def port_device(root, torch):
    """The card (its nvidia-smi name and power limit), with the port
    imported from the checkout at ``root`` and nowhere else."""
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, root)
    import acme_tpu_torch
    if not os.path.abspath(acme_tpu_torch.__file__).startswith(root + os.sep):
        raise SmokeFailure(f"acme_tpu_torch imported from "
                           f"{acme_tpu_torch.__file__}, not from {root}")
    card = smi()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | {root}")
    return card


def port_paths(root, torch):
    """The card, and the main, level and full paths' production runners
    of the checkout at ``root`` with the main path's seeds, their lane
    values and the level sweep's; each runner's build (and its power-up
    sibling's) compiled, ptxas's numbers and the SASS size printed."""
    card = port_device(root, torch)
    from acme_tpu_torch import FusedRunner
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.ops import build as B
    dev = torch.device("cuda", 0)
    t0 = time.time()
    m_so, m_lvl, m_full = S.build_models(
        [S.model_spec("pots", "chain", FS), S.model_spec("level", "chain", FS),
         S.model_spec("level", "full", FS)])
    fr_so = FusedRunner(m_so, lane_input_idx=(1, 2), device=dev,
                        powerup="steady", **S.PRODUCTION)
    seed = load_steady_seed(os.path.join(root, ".steadyseed_cache.npz"),
                            SEED_TAG, fr_so)
    _, _, _, lane_values, _ = S.lane_grid("pots", L_MAIN)
    _, _, _, lv_level, lv_cfg = S.lane_grid("level", L_MAIN)
    cold = dict(device=dev, powerup="safe", powerup_samples=POWERUP_SAMPLES,
                **S.PRODUCTION, **lv_cfg)
    runners = {"main": fr_so, "level": FusedRunner(m_lvl, **cold),
               "full": FusedRunner(m_full, **cold)}
    log(f"[3 model] main, level and full runners in "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    builds = dict(runners)
    for n in ("level", "full"):
        builds[n + " powerup"] = runners[n]._powerup_runner()
    with ThreadPoolExecutor(BUILD_WORKERS) as ex:
        paths = dict(zip(builds, ex.map(lambda r: B.compile_library(r.plan),
                                        builds.values())))
        log(f"[2 build] {len(paths)} builds in {time.time() - t0:.1f}s")
        # a checkout from before build.build_log: this process's log
        logs = {name: B.build_log(path) if hasattr(B, "build_log")
                else B.LAST_BUILD.get(path, (0.0, ""))
                for name, path in paths.items()}
        extra = dict(zip(paths, ex.map(
            lambda n: fused_build_lines(paths[n], logs[n][1],
                                        builds[n].plan, B), paths)))
    for name, path in paths.items():
        secs, out = logs[name]
        log(f"[2 build] {name}: nvcc {secs:.1f}s -> "
            f"{os.path.basename(path)}")
        for ln in [f"ptxas: {v}" for v in ptxas_lines(out)] + extra[name]:
            log(f"    {ln}")
    return card, runners, seed, lane_values, lv_level


def parity_seeds():
    """The main path's 18 parity lanes' values and their steady seeds
    (``engine_seeds``, a batch of their own: about a minute of host
    numpy): (lane values (18, 2), seeds)."""
    from acme_tpu_torch import sweeps as S
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    return S.lane_grid("pots", L_MAIN)[3][lanes], engine_seeds(lanes)


def save_seeds(path, lv18, seeds):
    x, warms, secs = seeds
    np.savez(path, lv=lv18, x=x, secs=secs, **{
        f"w{k}_{j}": v for k, w in enumerate(warms) for j, v in enumerate(w)})


def load_seeds(path):
    with np.load(path) as f:
        nsub = len({k.split("_")[0] for k in f.files if k[0] == "w"})
        return f["lv"], (f["x"], [tuple(f[f"w{k}_{j}"] for j in range(3))
                                  for k in range(nsub)], float(f["secs"]))


def tiled_seeds(lv18, seeds, L, dev, torch):
    """The 18 parity lanes' values and seeds tiled to L lanes (lane i runs
    parity lane i % 18): (lane values (L, 2), engine state on ``dev``)."""
    idx = np.arange(L) % len(lv18)
    x, warms, secs = seeds
    return lv18[idx], engine_state(
        (x[idx], [tuple(v[idx] for v in w) for w in warms], secs), dev, torch)


def engine_scaling(cm, lv18, seeds, u, card, torch, E):
    """Phase 4s for the engine's main build: one launch of
    SCALING_SAMPLES samples at each lane count of SCALING_LANES (the 18
    parity lanes' values and seeds tiled), each timed with CUDA events:
    kernel ms, lane-samples per second, Newton iterations per lane-sample,
    the bound, and the first 4096 lanes bit for bit as the 4096-lane
    launch (the lanes are independent)."""
    label = "4s lane scaling, engine main build"
    T = SCALING_SAMPLES
    ut = cm._as(u[:, :T])
    lv, st = tiled_seeds(lv18, seeds, SCALING_LANES[0], cm.device, torch)
    # the first launch of a library also loads its module
    cm._scan(st, cm._sweep_src(ut[:, :16], cm._as(lv), (1, 2)), 16)
    rates, first = {}, None
    for L in SCALING_LANES:
        lv, st = tiled_seeds(lv18, seeds, L, cm.device, torch)
        src = cm._sweep_src(ut, cm._as(lv), (1, 2))
        E.LAUNCH_EVENTS = []
        s_out, (y, conv, iters) = cm._scan(st, src, T)
        torch.cuda.synchronize()
        (a, b), = E.LAUNCH_EVENTS
        E.LAUNCH_EVENTS = None
        ms = a.elapsed_time(b)
        rate = L * T / (ms / 1e3)
        b_ms, b_by = engine_bound(cm, src, L, T, iters, torch)
        leaves = [s_out["x"]] + [v for w in s_out["warms"] for v in w]
        if first is None:
            first = (y, conv, iters, leaves)
            L0 = L
        else:
            n = first[0].shape[1]
            bad = [name for name, p, q in (("y", y[:, :n], first[0]),
                                           ("converged", conv[:, :n],
                                            first[1]),
                                           ("iters", iters[:, :n], first[2]))
                   if not torch.equal(p, q)]
            bad += ["state"] * (not all(torch.equal(p[:n], q) for p, q in
                                        zip(leaves, first[3])))
            if bad:
                raise SmokeFailure(f"{label}: the first {n} of {L} lanes "
                                   f"differ from the {n}-lane launch in "
                                   f"{bad}")
        rates[L] = rate
        log(f"[{label}] {L} lanes x {T} samples: kernel {ms:.1f} ms, "
            f"{rate / 1e6:.3f} M lane-samples/s ({rate / rates[L0]:.2f} x "
            f"the {L0}-lane rate), Newton iterations per lane-sample "
            f"{float(iters.double().sum(-1).mean()):.3f}, bound {b_ms:.3f} ms "
            f"({b_by}) | card: {card}")
        del y, conv, iters, s_out, leaves


def scaling_main():
    """``--scaling``: phases 1 and 2 for the main, level and full paths,
    then phase 4s for the main path's build from the seeds and for the
    full path's from the state its power-up window left; then the engine's
    main build (its ptxas numbers, and phase 4s from the 18 parity lanes'
    seeds, computed in a worker process from the start).  No result
    line."""
    import torch
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        sys.path.insert(0, HERE)
        job = pool.apply_async(parity_seeds)
        card, runners, seed, lane_values, lv_level = port_paths(HERE, torch)
        from acme_tpu_torch import engine as E
        from acme_tpu_torch import sweeps as S
        from acme_tpu_torch.engine import compile_model
        from acme_tpu_torch.ops import build as B
        from acme_tpu_torch.ops import fused as F
        from acme_tpu_torch.ops.emit import op_counts
        u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
        t0 = time.time()
        lane_scaling("4s lane scaling, main path", runners["main"], u,
                     lane_values, seed, card, torch, F, op_counts)
        full_scaling("4s lane scaling, full path", runners["full"], u,
                     lv_level, card, torch, F, op_counts)
        (m_so,) = S.build_models([S.model_spec("pots", "chain", FS)])
        eng = {"main": compile_model(m_so, tol=ENGINE_TOL,
                                     device=torch.device("cuda", 0))}
        with ThreadPoolExecutor(1) as ex:
            log_engine_builds(start_engine_builds(ex, eng, B), eng, B)
        lv18, seeds = job.get()
        log(f"[4s lane scaling] the 18 parity lanes' seeds: {seeds[2]:.1f}s "
            "of host time")
        engine_scaling(eng["main"], lv18, seeds, u, card, torch, E)
        log(f"[4s lane scaling] {time.time() - t0:.1f}s")
    finally:
        pool.terminate()
        pool.join()


def tensors_digest(tensors):
    """sha256 of the tensors' bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def digest(window):
    """sha256 of one window's (y, state, fails, iters, floored) bits."""
    (y, state), info = window[4], window[1]
    return tensors_digest([y] + [state[k] for k in sorted(state)] + [
        info.fails, info.iters, info.floored])


def engine_windows(lv18, seeds, card, torch):
    """``--windows``' engine paths, each in float64 (the references'
    tolerance) and float32 (its default tolerance), one library for both:
    the main build over one 1-s window of ``run_sweep`` from the 18 parity
    lanes' seeds tiled to 4096 lanes ("engine main"), and the level
    window through ``run`` from cold ("engine level").  Each window timed
    whole and its launch alone, with a digest of its y, state, converged
    and iters; the float64 windows' warp divergence.  Returns {path:
    {"ms", "kernel_ms", "digest"}}."""
    from acme_tpu_torch import engine as E
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.engine import compile_model
    from acme_tpu_torch.ops import build as B
    dev = torch.device("cuda", 0)
    t0 = time.time()
    m_so, m_lvl = S.build_models([S.model_spec("pots", "chain", FS),
                                  S.model_spec("level", "chain", FS)])
    f32 = dict(dtype=torch.float32, warn=False, device=dev)
    eng = {"engine main": compile_model(m_so, tol=ENGINE_TOL, device=dev),
           "engine main f32": compile_model(m_so, **f32),
           "engine level": compile_model(m_lvl, tol=ENGINE_TOL, device=dev),
           "engine level f32": compile_model(m_lvl, **f32)}
    log(f"[3 model] main and level Super Over, engine runners {list(eng)} "
        f"in {time.time() - t0:.1f}s")
    t0 = time.time()
    with ThreadPoolExecutor(BUILD_WORKERS) as ex:
        builds = start_engine_builds(ex, eng, B)
        log_engine_builds(builds, eng, B)
    log(f"[2 build] {len(builds)} engine builds in {time.time() - t0:.1f}s")
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
    levels = S.lane_grid("level", L_MAIN)[0]
    lv, st = tiled_seeds(lv18, seeds, L_MAIN, dev, torch)
    out = {}
    for name, cm in eng.items():
        if "main" in name:
            ut, lvt = cm._as(u), cm._as(lv)
            call = lambda cm=cm, ut=ut, lvt=lvt: cm.run_sweep(
                ut, lvt, (1, 2), state=st)
        else:
            lvl_u = cm._as(levels)[:, None, None] * cm._as(u)[None]
            call = lambda cm=cm, lvl_u=lvl_u: cm.run(lvl_u)
        E.LAUNCHES.clear()
        E.LAUNCH_EVENTS = []
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        y, state, info = call()
        e1.record()
        torch.cuda.synchronize()
        k_ms = sum(a.elapsed_time(b) for a, b in E.LAUNCH_EVENTS)
        E.LAUNCH_EVENTS = None
        if dict(E.LAUNCHES) != {cm.launch_key(): 1}:
            raise SmokeFailure(f"{name}: launches {dict(E.LAUNCHES)}")
        ms = e0.elapsed_time(e1)
        h = hashlib.sha256()
        for t in [y, state["x"]] + [v for w in state["warms"] for v in w] \
                + [info.converged, info.iters]:
            h.update(t.contiguous().cpu().numpy().tobytes())
        its = info.iters.sum(dtype=torch.float64) / info.converged.numel()
        log(f"[ab {name} path] window 1: {L_MAIN} lanes x {u.shape[1]} "
            f"samples {ms:.1f} ms (kernel {k_ms:.1f} ms) | RT-factor per "
            f"lane {(u.shape[1] / FS) / (ms / 1e3):.3f}x | Newton iterations "
            f"per lane-sample {float(its):.3f} | "
            f"non-converged lane-samples {int((~info.converged).sum())} | "
            f"card: {card}")
        if not name.endswith("f32"):
            warp_divergence(f"ab {name} path", info.iters, card, torch)
        out[name] = {"ms": [ms], "kernel_ms": [k_ms],
                     "digest": [h.hexdigest()]}
        del y, state, info, its
    return out


def windows_main(args):
    """``--windows ROOT [--engine-only | --fused-only] [--full-scaling]
    [--seeds FILE]``: the checkout at ROOT's main path (its first
    AB_MAIN_WINDOWS windows from the seeds), then the level and full
    paths' first window from cold (not with ``--engine-only``), with
    ``--full-scaling`` then the full path's lane scaling (phase 4s), then
    the engine's paths (``engine_windows``, not with ``--fused-only``)
    from the 18 parity lanes' seeds in FILE (``save_seeds``; computed
    here without it); the last line one JSON object: each path's window
    ms, kernel ms and digests."""
    import torch
    root = args[0]
    seeds_file = args[args.index("--seeds") + 1] if "--seeds" in args \
        else None
    out = {}
    if "--engine-only" in args:
        card = port_device(os.path.abspath(root), torch)
    else:
        card, runners, seed, lane_values, lv_level = port_paths(
            os.path.abspath(root), torch)
        from acme_tpu_torch.ops import fused as F
        from acme_tpu_torch.ops.emit import op_counts
        u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
        for name, lv, state, windows in (
                ("main", lane_values, seed, AB_MAIN_WINDOWS),
                ("level", lv_level, None, 1), ("full", lv_level, None, 1)):
            *_, rows = drive_path(f"ab {name} path", runners[name], u, lv,
                                  state, windows, [0], card, torch, F,
                                  op_counts, hold=windows)
            out[name] = {"ms": [r[0] for r in rows],
                         "kernel_ms": [sum(r[2]) for r in rows],
                         "digest": [digest(r) for r in rows]}
            del rows
        if "--full-scaling" in args:
            for L, (ms, dg) in full_scaling(
                    "ab lane scaling, full path", runners["full"], u,
                    lv_level, card, torch, F, op_counts).items():
                out[f"full {L} lanes"] = {"ms": [ms], "kernel_ms": [ms],
                                          "digest": [dg]}
        del runners
    if "--fused-only" not in args:
        lv18, seeds = load_seeds(seeds_file) if seeds_file \
            else parity_seeds()
        out.update(engine_windows(lv18, seeds, card, torch))
    print(json.dumps({"root": root, "card": card, "paths": out}))


def ab_main(args):
    """``--ab [--engine-only | --fused-only] [--full-scaling] ROOT
    [ROOT ...]``: ``--windows`` for each checkout in the order given, each
    in a process of its own, every visit from the 18 parity lanes' seeds
    computed once here (not with ``--fused-only``); fails unless every
    visit's windows are bit for bit the first visit's.  Prints each visit's
    kernel ms and each checkout's mean against the first checkout's."""
    import tempfile
    flags = ("--engine-only", "--fused-only", "--full-scaling")
    only = [a for a in args if a in flags]
    roots = [a for a in args if a not in flags]
    sys.path.insert(0, HERE)
    visits = []
    with tempfile.TemporaryDirectory() as tmp:
        seeds_file = []
        if "--fused-only" not in only:
            t0 = time.time()
            lv18, seeds = parity_seeds()
            log(f"[ab] the 18 parity lanes' seeds: {time.time() - t0:.1f}s")
            seeds_file = ["--seeds", os.path.join(tmp, "seeds.npz")]
            save_seeds(seeds_file[1], lv18, seeds)
        for root in roots:
            t0 = time.time()
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--windows", root]
                + seeds_file + only, capture_output=True, text=True,
                timeout=1800)
            lines = run.stdout.strip().splitlines()
            for ln in lines[:-1]:
                log(f"  {ln}")
            if run.returncode != 0 or not lines:
                log(run.stderr[-4000:])
                raise SmokeFailure(f"--windows {root} exited "
                                   f"{run.returncode}")
            visits.append(json.loads(lines[-1]))
            log(f"[ab] {root}: {time.time() - t0:.1f}s")
    first = visits[0]["paths"]
    for v in visits[1:]:
        for name, p in v["paths"].items():
            if p["digest"] != first[name]["digest"]:
                raise SmokeFailure(f"--ab: {v['root']}'s {name} path is not "
                                   f"bit for bit as {visits[0]['root']}'s")
    log(f"[ab] every visit bit for bit as the first in y, state, fails, "
        f"iters and floored (the engine's: y, state, converged and iters) "
        f"| card: {visits[0]['card']}")
    means = {}
    for name in first:
        for v in visits:
            log(f"[ab] {name} path, {v['root']}: kernel ms "
                f"{', '.join(f'{x:.1f}' for x in v['paths'][name]['kernel_ms'])}"
                f"; window ms "
                f"{', '.join(f'{x:.1f}' for x in v['paths'][name]['ms'])}")
        for root in dict.fromkeys(roots):
            ks = [k for v in visits if v["root"] == root
                  for k in v["paths"][name]["kernel_ms"]]
            means[name, root] = sum(ks) / len(ks)
        for root in dict.fromkeys(roots):
            log(f"[ab] {name} path, {root}: mean kernel ms "
                f"{means[name, root]:.1f} = "
                f"{means[name, root] / means[name, roots[0]]:.4f} x "
                f"{roots[0]}'s")


def trace_cost_main():
    """``--trace-cost``: see the module's docstring."""
    import contextlib
    import statistics
    import torch
    from acme_tpu_torch import FusedRunner, trace
    from acme_tpu_torch.models import superover_model
    from acme_tpu_torch.ops import fused as F
    sys.path.insert(0, os.path.join(HERE, "benchmark"))
    import gen
    dev = torch.device("cuda", 0)
    log(f"[trace-cost] {smi()}")
    with open(os.path.join(HERE, "benchmark", "configs",
                           "superover_full.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "benchmark", "traffic",
                           "full_level.json")) as f:
        traffic = json.load(f)
    lanes = gen.lane_values(traffic["lanes"], 7)
    stream = gen.Stream(traffic["stream"], 7, cfg["fs"])
    T = int(traffic["block"])
    fr = FusedRunner(superover_model(**cfg["model"], fs=cfg["fs"]),
                     device=dev, **cfg["runner"])
    W = int(cfg["runner"]["powerup_samples"])
    _, state, _ = fr.run(stream.block(0, W)[None], lanes)
    _, state, _ = fr.run(stream.block(W, T)[None], lanes, state=state)
    u = stream.block(W + T, T)[None]
    torch.cuda.synchronize(dev)
    F.LAUNCH_EVENTS = []
    rows = {"off": [], "on": []}
    first = counts = sums = None
    trace.clear()
    for turn in ("off", "on", "on", "off"):
        for _ in range(TRACE_COST_CALLS):
            ctx = trace.recording() if turn == "on" \
                else contextlib.nullcontext()
            a = len(F.LAUNCH_EVENTS)
            t0 = time.perf_counter()
            with ctx:
                y, st, info = fr.run(u, lanes, state=state)
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            kms = sum(e0.elapsed_time(e1) for e0, e1 in F.LAUNCH_EVENTS[a:])
            rows[turn].append((kms, (t1 - t0) * 1e3 - kms))
            out = (y, *st.values(), info.fails, info.iters, info.floored)
            if first is None:
                first = [t.clone() for t in out]
            elif not all(torch.equal(p, q) for p, q in zip(first, out)):
                raise SmokeFailure("--trace-cost: a call's outputs differ "
                                   "from the first call's")
            if turn == "on":
                # the recorder's sums: this call's counts are what it added
                c = info.tiers[6:].cpu()
                call = c - (sums if sums is not None else 0)
                sums = c
                if counts is None:
                    counts = call
                elif not torch.equal(call, counts):
                    raise SmokeFailure("--trace-cost: two traced calls "
                                       "counted different events")
    F.LAUNCH_EVENTS = None
    med = {}
    for turn, r in rows.items():
        k = [a for a, _ in r]
        h = [b for _, b in r]
        med[turn] = (statistics.median(k), statistics.median(h))
        log(f"[trace-cost] {turn}: kernel ms {k}; host ms {h}; medians "
            f"{med[turn][0]:.3f} / {med[turn][1]:.3f}")
    log(f"[trace-cost] on/off: kernel ms x {med['on'][0] / med['off'][0]:.5f}"
        f", host ms {med['on'][1] - med['off'][1]:+.3f} a call")
    log(f"[trace-cost] snapshot {json.dumps(trace.snapshot())}")
    # what one span costs the host: off, inside recording(), under a
    # profiler (a call makes seven)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, ctx in (("off", contextlib.nullcontext()),
                       ("recording", trace.recording()),
                       ("profiler", profile(activities=acts))):
        with ctx:
            t0 = time.perf_counter()
            for _ in range(2000):
                with trace.span("acme.cost"):
                    pass
            us = (time.perf_counter() - t0) / 2000 * 1e6
        log(f"[trace-cost] one span, {label}: {us:.2f} us")
    trace.clear()


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--trace-cost"]:
            trace_cost_main()
        elif sys.argv[1:2] == ["--scaling"]:
            scaling_main()
        elif sys.argv[1:2] == ["--engine"]:
            engine_main()
        elif sys.argv[1:2] == ["--golden"]:
            golden_main()
        elif sys.argv[1:2] == ["--windows"]:
            windows_main(sys.argv[2:])
        elif sys.argv[1:2] == ["--ab"]:
            ab_main(sys.argv[2:])
        else:
            main()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
