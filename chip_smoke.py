"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py            # the whole run (needs one CUDA card)
    python3 chip_smoke.py --scaling  # phases 1, 2 and 4s alone
    python3 chip_smoke.py --ab ROOT [ROOT ...]
                                     # the same windows of each checkout
                                     # ROOT in turns, bit for bit

Phases, each printed with its seconds:
  1. the device (name, power limit, torch / CUDA / nvcc versions);
  3. the models, built by the port's own compiler, the exact part of every
     Super Over build in a pool of worker processes: the main path's (the
     chain-decomposed Super Over with drive and tone as per-lane inputs,
     its runner preparation and the committed steady seeds), the level
     sweep's (the same circuit with fixed pots, its input scaled per
     lane), the presets sweep's (eight of those at other pot positions,
     the per-lane models of ONE runner: every coefficient that differs
     between them reaches the kernel in two per-lane tables) and the
     un-decomposed Super Over (one 7x7 subsystem);
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
     ``fast_verify="merge"``); meanwhile, in worker processes on the
     host, the presets path's float64 references;
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
     how many lanes' evaluations differ between the four (reported); a
     kernel's time is the median of three launches queued behind a
     warm-up launch;
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
     width): the level path's model, lanes and input; one power-up
     window with the ablation's base configuration, then for each row
     (``ablate.ROWS``) one warm window and three timed chained windows
     from that state; its RT-factor per lane, fails, evaluations per
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
  6. the kernel launch counts of each path, by build (library).
The "kernels" line has one entry per build: the main path's, the
production and power-up builds of the level, presets and full paths, each
ablation build (the level path's production build is also the ablation's
cf2) and its power-up build, the two verdict tiers' builds, and the
groups path's two.
Each kernel's bound (the least time the card could take for the same
work) is the larger of its float operations, counted from the generated
code and the build's configuration (``ops.emit.op_counts``: its
evaluations in their tiers) with the evaluations per lane-sample the run
measured, over the H100's float32 peak, and its bytes (inputs read once,
outputs written once) over the card's memory rate.
The last line is {"ok": true, "device": {...}}; any failed phase exits
nonzero before it.

Two measurements run alone, with no result line:
  4s. ``--scaling``: the main path's production build and the full
     path's at 4096, 8192, 16384 and 32768 lanes (the 4096 lanes' values
     and state tiled: the main path's from the seeds over 4096 samples,
     the full path's from where its power-up window left it over 2048),
     one launch each: kernel ms, aggregate lane-samples per second, and
     the first 4096 lanes bit for bit as the 4096-lane launch; ptxas's
     numbers and the SASS size of each build;
  ab. ``--ab ROOT [ROOT ...]``: for each checkout of the repo in the order
     given (a checkout named twice runs twice: parent, change, change,
     parent), a process of its own (``--windows ROOT``) that builds that
     checkout's main, level and full paths' builds and runs the main
     path's first two windows from the seeds and the level and full
     paths' first window from cold, printing kernel ms per window; every
     visit's outputs bit for bit as the first's (a digest of y, state,
     fails, iters and floored), each checkout's kernel ms against the
     first's.
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
# nvcc processes at a time
BUILD_WORKERS = 12
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and device memory
PEAK_FP32 = 67e12
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
    for bit as the 4096-lane launch (the lanes are independent)."""
    L0 = lane_values.shape[0]
    rates, first = {}, None
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
        del y, st_out


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
    bad += [f for f, a, b in zip(got[1]._fields, got[1], want[1])
            if not a.equal(b)]
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
    and three timed windows from that state (``ablate.measure``), each
    launch timed alone, with the bound of the last.  Returns ({row: its
    numbers}, the launch counts by build)."""
    F.LAUNCHES.clear()
    F.LAUNCH_EVENTS = []
    state0 = ablate.power_up(base_pu, lane_values, u)
    out, y_base = {}, None
    for name, fr in abl.items():
        n0 = len(F.LAUNCH_EVENTS)
        r = ablate.measure(fr, u, lane_values, state0, keep=lanes)
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


def main():
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    from acme_tpu_torch import FusedRunner, ablate
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.models import birdie_model, diodeclipper_model
    from acme_tpu_torch.ops import build as B
    from acme_tpu_torch.ops import fused as F
    from acme_tpu_torch.ops.emit import model_header, op_counts

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
    m_so, m_lvl, m_full, *m_pre = S.build_models(
        [S.model_spec("pots", "chain", FS), S.model_spec("level", "chain", FS),
         S.model_spec("level", "full", FS)] + pre_specs)
    log(f"[3 model] {3 + len(m_pre)} Super Over models built in "
        f"{time.time() - t0:.1f}s (worker processes)")
    # the models as built, for the runners of phases 5e and 5f (a runner's
    # centering runs the model's stateful host solvers)
    m_so_built, m_lvl_built = copy.deepcopy(m_so), copy.deepcopy(m_lvl)
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
        secs, out = B.LAST_BUILD.get(path, (0.0, "(cached)"))
        # the entry's registers and frame, and any function that spills
        regs = [ln.strip() for ln in out.splitlines()
                if "Used" in ln or ("stack frame" in ln and not
                                    ln.strip().startswith("0 bytes stack "
                                                          "frame, 0 bytes"))]
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
    for r in runners.values():
        B.load_kernel(r.plan)
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
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    y_pw, y_st, main_launches, _, main_rows = drive_path(
        "5 main path", fr_so, u, lane_values, seed, WINDOWS, lanes, card,
        torch, F, op_counts, hold=MESH_WINDOWS)
    main_rows = main_rows[:MESH_WINDOWS]
    score("5 main path", lanes,
          [f"drive {drive[i]:.3f}, tone {tone[i]:.3f}" for i in lanes],
          y_pw, y_st,
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
    # the ablation path: four windows per row; the base's build also runs
    # the power-up window's production part, its power-up build the rest
    rows_of = {}
    for name in abl:
        rows_of.setdefault(lib_of["ablation " + name], []).append(name)
    abl_expected = {lib: 4 * len(rows) for lib, rows in rows_of.items()}
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
    log(f"[total] {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def sass_size(path):
    """(instructions, bytes) of the kernel's SASS in library ``path``
    (``cuobjdump -sass``; (0, 0) without it): the instruction stream its
    warps fetch."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True, timeout=300).stdout
    except (OSError, subprocess.SubprocessError):
        return 0, 0
    n = len(re.findall(r"/\*[0-9a-f]{4,}\*/", out))
    return n, 16 * n


def port_paths(root, torch):
    """The card, and the main, level and full paths' production runners
    of the checkout at ``root`` with the main path's seeds, their lane
    values and the level sweep's; each runner's build (and its power-up
    sibling's) compiled, ptxas's numbers and the SASS size printed."""
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, root)
    import acme_tpu_torch
    from acme_tpu_torch import FusedRunner
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.ops import build as B
    if not os.path.abspath(acme_tpu_torch.__file__).startswith(root + os.sep):
        raise SmokeFailure(f"acme_tpu_torch imported from "
                           f"{acme_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    card = smi()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | {root}")
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
    for name, path in paths.items():
        secs, out = B.LAST_BUILD.get(path, (0.0, ""))
        n, nbytes = sass_size(path)
        log(f"[2 build] {name}: nvcc {secs:.1f}s -> {os.path.basename(path)}"
            f"; SASS {n} instructions ({nbytes / 1024:.0f} KiB)")
        for ln in out.splitlines():
            if "Used" in ln or ("stack frame" in ln and not ln.strip()
                                .startswith("0 bytes stack frame, 0 bytes")):
                log(f"    ptxas: {ln.strip()}")
    return card, runners, seed, lane_values, lv_level


def scaling_main():
    """``--scaling``: phases 1 and 2 for the main, level and full paths,
    then phase 4s for the main path's build from the seeds and for the
    full path's from the state its power-up window left.  No result
    line."""
    import torch
    card, runners, seed, lane_values, lv_level = port_paths(HERE, torch)
    from acme_tpu_torch.ops import fused as F
    from acme_tpu_torch.ops.emit import op_counts
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
    t0 = time.time()
    lane_scaling("4s lane scaling, main path", runners["main"], u,
                 lane_values, seed, card, torch, F, op_counts)
    *_, rows = drive_path("4s full path's power-up window", runners["full"],
                          u[:, :2 * POWERUP_SAMPLES], lv_level, None, 1, [0],
                          card, torch, F, op_counts, hold=1)
    lane_scaling("4s lane scaling, full path", runners["full"], u, lv_level,
                 rows[0][4][1], card, torch, F, op_counts,
                 samples=SCALING_SAMPLES // 2)
    log(f"[4s lane scaling] {time.time() - t0:.1f}s")


def digest(window):
    """sha256 of one window's (y, state, fails, iters, floored) bits."""
    (y, state), info = window[4], window[1]
    h = hashlib.sha256()
    for t in [y] + [state[k] for k in sorted(state)] + [
            info.fails, info.iters, info.floored]:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def windows_main(root):
    """``--windows ROOT``: the checkout at ROOT's main path (its first
    AB_MAIN_WINDOWS windows from the seeds), then the level and full
    paths' first window from cold; the last line one JSON object: each
    path's window ms, kernel ms and digests."""
    import torch
    card, runners, seed, lane_values, lv_level = port_paths(
        os.path.abspath(root), torch)
    from acme_tpu_torch.ops import fused as F
    from acme_tpu_torch.ops.emit import op_counts
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(FS)))[None, :]
    out = {}
    for name, lv, state, windows in (
            ("main", lane_values, seed, AB_MAIN_WINDOWS),
            ("level", lv_level, None, 1), ("full", lv_level, None, 1)):
        *_, rows = drive_path(f"ab {name} path", runners[name], u, lv, state,
                              windows, [0], card, torch, F, op_counts,
                              hold=windows)
        out[name] = {"ms": [r[0] for r in rows],
                     "kernel_ms": [sum(r[2]) for r in rows],
                     "digest": [digest(r) for r in rows]}
        del rows
    print(json.dumps({"root": root, "card": card, "paths": out}))


def ab_main(roots):
    """``--ab ROOT [ROOT ...]``: ``--windows`` for each checkout in the
    order given, each in a process of its own; fails unless every visit's
    windows are bit for bit the first visit's.  Prints each visit's kernel
    ms and each checkout's mean against the first checkout's."""
    visits = []
    for root in roots:
        t0 = time.time()
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--windows", root], capture_output=True,
                             text=True, timeout=1800)
        lines = run.stdout.strip().splitlines()
        for ln in lines[:-1]:
            log(f"  {ln}")
        if run.returncode != 0 or not lines:
            log(run.stderr[-4000:])
            raise SmokeFailure(f"--windows {root} exited {run.returncode}")
        visits.append(json.loads(lines[-1]))
        log(f"[ab] {root}: {time.time() - t0:.1f}s")
    first = visits[0]["paths"]
    for v in visits[1:]:
        for name, p in v["paths"].items():
            if p["digest"] != first[name]["digest"]:
                raise SmokeFailure(f"--ab: {v['root']}'s {name} path is not "
                                   f"bit for bit as {visits[0]['root']}'s")
    log(f"[ab] every visit bit for bit as the first in y, state, fails, "
        f"iters and floored | card: {visits[0]['card']}")
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


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--scaling"]:
            scaling_main()
        elif sys.argv[1:2] == ["--windows"]:
            windows_main(sys.argv[2])
        elif sys.argv[1:2] == ["--ab"]:
            ab_main(sys.argv[2:])
        else:
            main()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
