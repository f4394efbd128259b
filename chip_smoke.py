"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py            # the whole run (needs one CUDA card)

Phases, each printed with its seconds:
  1. the device (name, power limit, torch / CUDA / nvcc versions);
  2. the nvcc builds of the fused kernel, all started together: one per
     model below, and for the level sweep's model two (the production
     configuration and the power-up sibling's);
  3. the models, built by the port's own compiler: the main path's (the
     chain-decomposed Super Over with drive and tone as per-lane inputs,
     its runner preparation and the committed steady seeds) and the level
     sweep's (the same circuit with fixed pots, its input scaled per lane);
  4. kernel against its plain torch version on the card: the diode
     clipper (128 lanes x 1024 samples), birdie with its volume pot as a
     lane input (128 x 256), the Super Over (4096 x 64 from the seeds),
     and the level model's power-up build (4096 x 64 from cold) and
     production build (4096 x 64 from the state the power-up build left);
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
  6. the kernel launch counts of each path, by build (library).
The "kernels" line has one entry per build: the main path's, and the
level path's production and power-up builds.
Each kernel's bound (the least time the card could take for the same
work) is the larger of its float operations, counted from the generated
code (``ops.emit.op_counts``) times the evaluations per lane-sample the
run measured, over the H100's float32 peak, and its bytes (inputs read
once, outputs written once) over the card's memory rate.
The last line is {"ok": true, "device": {...}}; any failed phase exits
nonzero before it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
                  + 2 * L * nstate                    # state in and out
                  + T * max(plan.ny, 1) * L           # y
                  + L * (2 + nsub))                   # fails, floored, iters
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def compare_case(name, fr, u_time, lane_values, state, torch, F, op_counts):
    """Kernel (fused_step on CUDA tensors) against plain_run on the same
    CUDA tensors; returns (a dict of the numbers it printed, the kernel's
    state)."""
    u, lv, tol, gate = fr.prepare_inputs(u_time, lane_values)
    state = {k: v.contiguous() for k, v in state.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    # warm-up launch: the first launch of a library also loads its module
    F.fused_step(fr.plan, u, lv, tol, gate, state)
    torch.cuda.synchronize()
    ev[0].record()
    yk, stk, fk, ik, flk = F.fused_step(fr.plan, u, lv, tol, gate, state)
    ev[1].record()
    yp, stp, fp, ip, flp = F.plain_run(fr.plan, u, lv, tol, gate, state)
    ev[2].record()
    torch.cuda.synchronize()
    ms_k = ev[0].elapsed_time(ev[1])
    ms_p = ev[1].elapsed_time(ev[2])
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
    log(f"  {name}: L={L} T={T}  kernel {ms_k:.3f} ms, "
        f"plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})  y worst lane "
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
    if bad:
        raise SmokeFailure(f"{name}: kernel disagrees with plain: {bad}")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_abs, bound_ms=b_ms,
                bound_by=b_by), stk


def drive_path(label, fr, u, lane_values, state, windows, keep, card, torch,
               F, op_counts):
    """Chain ``windows`` runs of ``fr`` through its public ``run``, each
    timed whole (CUDA events around the call) and each kernel launch
    alone (``fused.LAUNCH_EVENTS``).  The launch counts are set to 0 just
    before and read just after.  Returns (the first and the last window's
    outputs on the lanes ``keep``, the launch counts by build)."""
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
        rows.append((e0.elapsed_time(e1), info,
                     [a.elapsed_time(b) for a, b in F.LAUNCH_EVENTS[n0:]]))
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
    for w, (ms, info, k_ms) in enumerate(rows):
        fails = info.fails.cpu().numpy()
        fl = info.floored.cpu().numpy()
        its = info.iters.cpu().numpy()
        evals = its.mean(0) / T
        b_ms, b_by = bound(fr.plan, L, T, evals, F, op_counts)
        rt = (T / FS) / (ms / 1e3)
        log(f"[{label}] window {w + 1}: {L} lanes x {T} samples "
            f"{ms:.1f} ms (kernel {' + '.join(f'{k:.1f}' for k in k_ms)} "
            f"ms, outside it {ms - sum(k_ms):.1f} ms = "
            f"{100 * (ms - sum(k_ms)) / ms:.2f} %) | RT-factor per lane "
            f"{rt:.3f}x | {L * T / (ms / 1e3) / 1e6:.3f} Msamples/s | "
            f"fails mean {fails.mean():.4f} max {int(fails.max())} | "
            f"floored mean {fl.mean():.4f} max {int(fl.max())} | "
            f"evals/lane-sample {its.sum(1).mean() / T:.3f} | bound "
            f"{b_ms:.3f} ms ({b_by}, production build's counts) | card: "
            f"{card}")
    return y_first, y_last, launches


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    from acme_tpu_torch import FusedRunner
    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.models import birdie_model, diodeclipper_model
    from acme_tpu_torch.ops import build as B
    from acme_tpu_torch.ops import fused as F
    from acme_tpu_torch.ops.emit import op_counts

    dev = torch.device("cuda", 0)
    card = smi()
    kind = torch.cuda.get_device_name(0)

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
    m_so = S.build_model("pots", "chain", FS)
    t_model = time.time() - t0
    fr_so = FusedRunner(m_so, lane_input_idx=(1, 2), device=dev,
                        powerup="steady")
    fr_clip = FusedRunner(diodeclipper_model(), device=dev)
    fr_bird = FusedRunner(birdie_model(), lane_input_idx=(1,), device=dev)
    _, drive, tone, lane_values, _ = S.lane_grid("pots", L_MAIN)
    seed = load_steady_seed(os.path.join(HERE, ".steadyseed_cache.npz"),
                            SEED_TAG, fr_so)
    log(f"[3 model] Super Over nx={m_so.nx} nn={[m_so.nn(k) for k in range(m_so.nsubsystems)]} "
        f"np={[m_so.np(k) for k in range(m_so.nsubsystems)]} build "
        f"{t_model:.1f}s, runners + seeds {time.time() - t0 - t_model:.1f}s; "
        f"sub_fragile={fr_so.sub_fragile} "
        f"cond_eq={[float(f'{c:.3g}') for c in fr_so.sub_cond_eq]}")
    t0 = time.time()
    m_lvl = S.build_model("level", "chain", FS)
    t_model = time.time() - t0
    levels, _, _, lv_level, lv_cfg = S.lane_grid("level", L_MAIN)
    fr_lvl = FusedRunner(m_lvl, device=dev, powerup="safe",
                         powerup_samples=4096, **lv_cfg)
    pr_lvl = fr_lvl._powerup_runner()
    subs = range(m_lvl.nsubsystems)
    log(f"[3 model] level Super Over nx={m_lvl.nx} "
        f"nn={[m_lvl.nn(k) for k in subs]} "
        f"np={[m_lvl.np(k) for k in subs]} build "
        f"{t_model:.1f}s, runners {time.time() - t0 - t_model:.1f}s; "
        f"sub_fragile={fr_lvl.sub_fragile} "
        f"cond_eq={[float(f'{c:.3g}') for c in fr_lvl.sub_cond_eq]}")

    t0 = time.time()
    runners = {"clipper": fr_clip, "birdie": fr_bird, "superover": fr_so,
               "level": fr_lvl, "level powerup": pr_lvl}
    with ThreadPoolExecutor(len(runners)) as ex:
        futs = {n: ex.submit(B.compile_library, r.plan)
                for n, r in runners.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for n, path in libs.items():
        secs, out = B.LAST_BUILD.get(path, (0.0, "(cached)"))
        regs = [ln.strip() for ln in out.splitlines()
                if "acme_fused_kernel" in ln or "Used" in ln
                or "stack frame" in ln][:6]
        log(f"[2 build] {n} ({runners[n].plan.kernel_name}): nvcc "
            f"{secs:.1f}s -> {os.path.basename(path)}")
        for ln in regs:
            log(f"    ptxas: {ln}")
        B.load_kernel(runners[n].plan)
    log(f"[2 build] total {time.time() - t0:.1f}s (parallel)")

    t0 = time.time()
    log("[4 kernel vs plain] (card: " + card + ")")
    T = 1024
    u = (1.0 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    compare_case("clipper", fr_clip, u, np.zeros((128, 0)),
                 fr_clip.initial_state(128), torch, F, op_counts)
    T = 256
    u = (0.3 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    vols = np.linspace(0.05, 0.95, 128)[:, None]
    compare_case("birdie", fr_bird, u, vols, fr_bird.initial_state(128),
                 torch, F, op_counts)
    T = 64
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(2 * T)))[None, :]
    so, _ = compare_case("superover", fr_so, u[:, :T], lane_values, seed,
                         torch, F, op_counts)
    pw, st_pw = compare_case("level powerup", pr_lvl, u[:, :T], lv_level,
                             pr_lvl.initial_state(L_MAIN), torch, F,
                             op_counts)
    lvl, _ = compare_case("level", fr_lvl, u[:, T:], lv_level, st_pw, torch,
                          F, op_counts)
    log(f"[4 kernel vs plain] {time.time() - t0:.1f}s")

    t0 = time.time()
    T = FS
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    lanes = S.select_parity_lanes(L_MAIN, 16, S.stress_lanes("pots", L_MAIN))
    y_pw, y_st, main_launches = drive_path(
        "5 main path", fr_so, u, lane_values, seed, WINDOWS, lanes, card,
        torch, F, op_counts)
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
    y_pw, y_st, level_launches = drive_path(
        "5b level path", fr_lvl, u, lv_level, None, LEVEL_WINDOWS, lanes,
        card, torch, F, op_counts)
    score("5b level path", lanes, [f"level {levels[i]:.4f}" for i in lanes],
          y_pw, y_st,
          [S.ref_key("level", "chain", FS, T, LEVEL_REPS, levels[i], 1.0,
                     1.0) for i in lanes],
          LEVEL_WINDOWS, LEVEL_PARITY_WORST_DB)
    # window 1's power-up launch once more, alone (the same cold start and
    # input, so the same work): its own kernel time and evaluations, hence
    # its own bound
    W = fr_lvl.powerup_samples
    F.LAUNCH_EVENTS = []
    _, _, info = pr_lvl.run(u[:, :W], lv_level, check=True)
    torch.cuda.synchronize()
    (e0, e1), = F.LAUNCH_EVENTS
    F.LAUNCH_EVENTS = None
    evals = info.iters.double().mean(dim=0).cpu().numpy() / W
    b_ms, b_by = bound(pr_lvl.plan, L_MAIN, W, evals, F, op_counts)
    log(f"[5b level path] power-up launch alone: {L_MAIN} lanes x {W} "
        f"samples, kernel {e0.elapsed_time(e1):.1f} ms, evals/lane-sample "
        f"{evals.sum():.3f}, bound {b_ms:.3f} ms ({b_by}) | card: {card}")
    log(f"[5b level path] {time.time() - t0:.1f}s")

    # one entry per build: (name, runner, its phase-4 check)
    builds = [("fused_sweep (Super Over pots, main path)", fr_so, so),
              ("fused_sweep (level Super Over, level path)", fr_lvl, lvl),
              ("fused_sweep_powerup (level Super Over, level path)", pr_lvl,
               pw)]
    by_name = lambda launches: {n: launches.get(r.plan.cuda_name, 0)
                                for n, r, _ in builds}
    log(f"[6 launches] main path {by_name(main_launches)}; level path "
        f"{by_name(level_launches)}")
    # one launch per window; the level path's window 1 adds the power-up
    libs = [r.plan.cuda_name for _, r, _ in builds]
    if len(set(libs)) != 3:
        raise SmokeFailure(f"the three builds share a library: {libs}")
    if main_launches != {libs[0]: WINDOWS}:
        raise SmokeFailure(f"main path launches {main_launches}, expected "
                           f"{WINDOWS} of {libs[0]}")
    if level_launches != {libs[1]: LEVEL_WINDOWS, libs[2]: 1}:
        raise SmokeFailure(f"level path launches {level_launches}, "
                           f"expected {LEVEL_WINDOWS} of {libs[1]} and 1 "
                           f"of {libs[2]}")

    kernels = []
    for name, r, case in builds:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "acme_tpu_torch/ops/csrc/fused.cu",
            "replaces": "acme_tpu/ops/fused.py:2483",
            "launches": (main_launches.get(r.plan.cuda_name, 0)
                         + level_launches.get(r.plan.cuda_name, 0)),
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
