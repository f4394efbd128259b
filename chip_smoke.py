"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py            # the whole run (needs one CUDA card)

Phases, each printed with its seconds:
  1. the device (name, power limit, torch / CUDA / nvcc versions);
  2. the nvcc build of the fused kernel for each model below;
  3. the main-path model (the chain-decomposed Super Over with drive and
     tone as per-lane inputs), its runner preparation and the committed
     steady seeds;
  4. kernel against its plain torch version on the card: the diode
     clipper (128 lanes x 1024 samples), birdie with its volume pot as a
     lane input (128 x 256) and the Super Over (4096 x 64 from the seeds);
  5. the main path: 4096 lanes x 44100 samples from the seeds, chained
     for seven windows as the JAX package's bench chains them, each timed
     whole and kernel alone; window 1 is scored against the committed
     float64 power-up references and window 7 against the steady ones;
  6. the kernel launch count of the main path.
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
# bench.py's reference protocol (the "r5" of the reference keys): window 1
# is the power-up reference ("_pw"), window 2 + 5 the steady one ("_st")
REF_KEY = "scan3_pots_chain_fs44100_T44100_r5_lv1.000000_d{:.6f}_t{:.6f}_steady"
WINDOWS = 7
# y agreement of two float32 implementations, relative to each lane's
# peak: their exp may differ by an ulp, which can move a lane onto another
# solver tier at a dead-zone crossing (tests/test_torch_fused.py's bound)
KERNEL_DB = -90.0
PARITY_WORST_DB = -50.0
PARITY_MEDIAN_DB = -95.0


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


def compare_case(name, fr, u_time, lane_values, state, torch, F):
    """Kernel (fused_step on CUDA tensors) against plain_run on the same
    CUDA tensors; returns a dict of the numbers it printed."""
    u, lv, tol, gate = fr.prepare_inputs(u_time, lane_values)
    state = {k: v.contiguous() for k, v in state.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
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
    log(f"  {name}: L={lv.shape[1]} T={u.shape[0]}  kernel {ms_k:.3f} ms, "
        f"plain {ms_p:.3f} ms  y worst lane {worst}: {db[worst]:.1f} dB "
        f"(median {np.median(db):.1f}), max|dy| {max_abs:.3e}  "
        f"fails {int(fk.sum())}/{int(fp.sum())} floored "
        f"{int(flk.sum())}/{int(flp.sum())}  state dB "
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
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_abs)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    # bench.py imports only the standard library at module level; its lane
    # grid and parity-lane rule pick the lanes the references were made for
    from bench import _lane_grid, _select_parity_lanes, _stress_lanes
    from acme_tpu.models import birdie_model, diodeclipper_model, \
        superover_model
    from acme_tpu_torch import FusedRunner
    from acme_tpu_torch.convert import load_steady_seed
    from acme_tpu_torch.ops import build as B
    from acme_tpu_torch.ops import fused as F

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
    m_so = superover_model(drive=None, tone=None, level=1.0, vb_source=True)
    t_model = time.time() - t0
    fr_so = FusedRunner(m_so, lane_input_idx=(1, 2), device=dev,
                        powerup="steady")
    fr_clip = FusedRunner(diodeclipper_model(), device=dev)
    fr_bird = FusedRunner(birdie_model(), lane_input_idx=(1,), device=dev)
    _, drive, tone, lane_values, _ = _lane_grid("pots", L_MAIN)
    seed = load_steady_seed(os.path.join(HERE, ".steadyseed_cache.npz"),
                            SEED_TAG, fr_so)
    log(f"[3 model] Super Over nx={m_so.nx} nn={[m_so.nn(k) for k in range(m_so.nsubsystems)]} "
        f"np={[m_so.np(k) for k in range(m_so.nsubsystems)]} build "
        f"{t_model:.1f}s, runners + seeds {time.time() - t0 - t_model:.1f}s; "
        f"sub_fragile={fr_so.sub_fragile} "
        f"cond_eq={[float(f'{c:.3g}') for c in fr_so.sub_cond_eq]}")

    t0 = time.time()
    runners = {"clipper": fr_clip, "birdie": fr_bird, "superover": fr_so}
    with ThreadPoolExecutor(3) as ex:
        futs = {n: ex.submit(B.compile_library, r.plan)
                for n, r in runners.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for n, path in libs.items():
        secs, out = B.LAST_BUILD.get(path, (0.0, "(cached)"))
        regs = [ln.strip() for ln in out.splitlines()
                if "acme_fused_kernel" in ln or "Used" in ln
                or "stack frame" in ln][:6]
        log(f"[2 build] {n}: nvcc {secs:.1f}s -> {os.path.basename(path)}")
        for ln in regs:
            log(f"    ptxas: {ln}")
        B.load_kernel(runners[n].plan)
    log(f"[2 build] total {time.time() - t0:.1f}s (parallel)")

    t0 = time.time()
    log("[4 kernel vs plain] (card: " + card + ")")
    T = 1024
    u = (1.0 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    compare_case("clipper", fr_clip, u, np.zeros((128, 0)),
                 fr_clip.initial_state(128), torch, F)
    T = 256
    u = (0.3 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    vols = np.linspace(0.05, 0.95, 128)[:, None]
    compare_case("birdie", fr_bird, u, vols, fr_bird.initial_state(128),
                 torch, F)
    T = 64
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    so = compare_case("superover", fr_so, u, lane_values, seed, torch, F)
    log(f"[4 kernel vs plain] {time.time() - t0:.1f}s")

    t0 = time.time()
    T = FS
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(T)))[None, :]
    lanes = _select_parity_lanes(L_MAIN, 16, _stress_lanes("pots", L_MAIN))
    F.KERNEL_LAUNCHES = 0
    F.LAUNCH_EVENTS = []
    windows = []
    state = seed
    y_pw = y_st = None
    for w in range(WINDOWS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        y, state, info = fr_so.run(u, lane_values, state=state, check=True)
        e1.record()
        torch.cuda.synchronize()
        windows.append((e0.elapsed_time(e1), info))
        # finite over every lane (run's check); the reference lanes kept
        if w == 0:
            y_pw = y[lanes, 0].cpu().numpy()
        y_st = y[lanes, 0].cpu().numpy()
    launches = F.KERNEL_LAUNCHES
    kernel_ms = [a.elapsed_time(b) for a, b in F.LAUNCH_EVENTS]
    F.LAUNCH_EVENTS = None
    if len(kernel_ms) != WINDOWS:
        raise SmokeFailure(f"{len(kernel_ms)} kernel launches timed over "
                           f"{WINDOWS} windows")
    for w, ((ms, info), k_ms) in enumerate(zip(windows, kernel_ms)):
        fails = info.fails.cpu().numpy()
        fl = info.floored.cpu().numpy()
        its = info.iters.cpu().numpy().sum(1)
        rt = (T / FS) / (ms / 1e3)
        log(f"[5 main path] window {w + 1}: {L_MAIN} lanes x {T} samples "
            f"{ms:.1f} ms (kernel {k_ms:.1f} ms, outside it "
            f"{ms - k_ms:.1f} ms = {100 * (ms - k_ms) / ms:.2f} %) | "
            f"RT-factor per lane {rt:.3f}x | "
            f"{L_MAIN * T / (ms / 1e3) / 1e6:.3f} Msamples/s | "
            f"fails mean {fails.mean():.4f} max {int(fails.max())} | "
            f"floored mean {fl.mean():.4f} max {int(fl.max())} | "
            f"iters/sample {its.mean() / T:.3f} | card: {card}")
    # bench.py's scoring: each lane's error relative to the peak of its
    # steady reference; window 1 against "_pw", window 7 against "_st"
    db_pw, db_st = [], []
    with np.load(os.path.join(HERE, ".hostref_cache.npz")) as cache:
        for j, i in enumerate(lanes):
            key = REF_KEY.format(drive[i], tone[i])
            ref_pw, ref_st = cache[key + "_pw"], cache[key + "_st"]
            scale = max(float(np.abs(ref_st).max()), 1e-12)
            db_pw.append(20 * np.log10(
                float(np.abs(y_pw[j] - ref_pw).max()) / scale + 1e-300))
            db_st.append(20 * np.log10(
                float(np.abs(y_st[j] - ref_st).max()) / scale + 1e-300))
            log(f"    parity lane {i} (drive {drive[i]:.3f}, tone "
                f"{tone[i]:.3f}): window 1 {db_pw[-1]:.1f} dB, window "
                f"{WINDOWS} {db_st[-1]:.1f} dB")
    bad = []
    for name, dbs in (("window 1 (_pw)", db_pw),
                      (f"window {WINDOWS} (_st)", db_st)):
        worst, med = max(dbs), float(np.median(dbs))
        log(f"[5 main path] parity {name} vs float64 references: worst "
            f"{worst:.1f} dB, median {med:.1f} dB over {len(dbs)} lanes")
        if worst > PARITY_WORST_DB or med > PARITY_MEDIAN_DB:
            bad.append(f"{name} worst {worst:.1f} / median {med:.1f} dB")
    if bad:
        raise SmokeFailure(f"parity outside {PARITY_WORST_DB} / "
                           f"{PARITY_MEDIAN_DB} dB: {bad}")
    log(f"[5 main path] {time.time() - t0:.1f}s")

    log(f"[6 launches] KERNEL_LAUNCHES={launches} over the main path")
    if launches <= 0:
        raise SmokeFailure("the main path never launched the kernel")

    print(json.dumps({"kernels": [{
        "name": "fused_sweep", "route": "cuda",
        "source": "acme_tpu_torch/ops/csrc/fused.cu",
        "replaces": "acme_tpu/ops/fused.py:2483",
        "launches": launches, "max_abs_err": so["max_abs_err"],
        "ms": so["ms"], "plain_ms": so["plain_ms"]}]}))
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
