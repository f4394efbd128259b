"""The cost anatomy of the fused kernel's step configurations, on the card.

The port of the JAX package's ``_ablate.py``, with the same configurations
under the same names and the same protocol: build the level sweep's Super
Over once (drive, tone and level pots at 1, the stiff vb bias source),
power 4096 input levels (0.1 to 2.0 of a 0.2-amplitude 1 kHz sine) up
once with the base configuration, then for each configuration build a
runner and, from that same powered-up state, run one warm window and
three timed chained windows of 44100 samples.  Accuracy is against the
base configuration's output (fused against fused, not float64:
``chip_smoke.py`` scores that); fails are reported.

    python -m acme_tpu_torch.ablate               # every configuration
    python -m acme_tpu_torch.ablate cf2 nopivot   # base first, then these

Beside ``_ablate.py``'s configurations, the row ``defaults`` is the runner
with its own defaults (the JAX package's: the robust path every sample,
the df polish loop), and ``EXTRA`` holds the knob values that
``_ablate.py`` does not ablate, each over cf2 (the production
configuration); all chained from the same state.  ``tc512`` is the JAX
runner's Mosaic time chunk, which the CUDA kernel does not have: it is
printed as skipped.  Needs one CUDA card; there is no CPU run.
"""

from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from . import sweeps
from .ops.fused import FusedRunner

__all__ = ["CONFIGS", "EXTRA", "ROWS", "SKIPPED", "BASE", "DEFAULTS",
           "row_kwargs",
           "level_inputs", "base_runner", "power_up", "measure",
           "vs_base_db", "row_line", "order", "main"]

FS = 44100
T = 44100
L = 4096
REPS = 3

CONFIGS = {
    # name: FusedRunner overrides
    "base":        dict(),
    "df_off":      dict(df_polish=False),
    "nopivot":     dict(pivot=False),
    "fast2":       dict(fast_iters=2),
    "pol1":        dict(polish_iters=1),
    "tc512":       dict(time_chunk=512),
    "polonly":     dict(polish_only=True, fast_iters=0),
    "polfix1":     dict(polish_fixed=1),
    # candidate production configs (combined knobs)
    "fix2v":       dict(polish_fixed=2, verdict_refine=0,
                        verdict_jac="plain"),
    "fix1v":       dict(polish_fixed=1, verdict_refine=0,
                        verdict_jac="plain"),
    "minimal":     dict(polish_fixed=1, df_polish=False,
                        compensated=False),
    "vjplain":     dict(verdict_jac="plain"),
    "vref0":       dict(verdict_refine=0),
    "noextrap":    dict(extrapolate=False),
    "polfix2":     dict(polish_fixed=2),
    "polfix3":     dict(polish_fixed=3),
    "comp_off":    dict(compensated=False, df_polish=False),
    # verdict-tier candidates at the production prefix depth
    "cf2":         dict(polish_fixed=2, df_polish="comp_final"),
    "pf2":         dict(polish_fixed=2),
    # eval-count reduction candidates: shallower polish prefix and
    # polish-only (the warm start's first polish step IS the Newton step)
    "cf1":         dict(polish_fixed=1, df_polish="comp_final"),
    "co2":         dict(polish_only=True, fast_iters=0, polish_fixed=2,
                        df_polish="comp_final"),
    "co1":         dict(polish_only=True, fast_iters=0, polish_fixed=1,
                        df_polish="comp_final"),
}
# the runner's knob values that _ablate.py does not ablate, each over cf2
_CF2 = CONFIGS["cf2"]
EXTRA = {
    "always":      dict(_CF2, fast_verify="always"),
    "keeptol":     dict(_CF2, fast_keep="tol"),
    "reltol":      dict(_CF2, rel_tol=1e-6, rel_gate=1e-5,
                        rel_tol_polish=1e-7),
    "nodfstate":   dict(_CF2, df_state=False),
}
# configurations of knobs the CUDA kernel does not have, and why
SKIPPED = {"tc512": "time_chunk is the Mosaic kernel's time-chunk size; "
                    "the CUDA kernel runs a whole window in one launch"}
# _ablate.py's base: the JAX runner's defaults but for these
BASE = dict(newton_iters=192, tol=1e-9, fast_iters=1,
            df_polish="plain_final", fast_verify="merge", powerup="safe")
# the row of the runner's own defaults
DEFAULTS = "defaults"
# every row, in run order but for base, which runs first
ROWS = list(CONFIGS) + [DEFAULTS] + list(EXTRA)


def row_kwargs(name):
    """The runner keywords of one row (chained runs only: no power-up)."""
    if name == DEFAULTS:
        return {}
    if name in SKIPPED:
        raise ValueError(f"{name}: {SKIPPED[name]}")
    kw = dict(BASE)
    kw.update(EXTRA[name] if name in EXTRA else CONFIGS[name])
    kw["powerup"] = None
    return kw


def level_inputs(lanes=L, samples=T):
    """(lane values (lanes, 1), u (1, samples)): the input levels and the
    sine."""
    levels = np.linspace(0.1, 2.0, lanes)
    u = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(samples)))[None, :]
    return levels[:, None], u


def base_runner(model, device):
    """The runner of the power-up window: the base configuration with the
    two-phase power-up."""
    return FusedRunner(model, lane_scale_idx=(0,), device=device, **BASE)


def power_up(fr, lane_values, u):
    """The state after one window of ``base_runner``'s ``fr`` from cold
    (the power-up sibling's first 4096 samples, then the base)."""
    y, state, _ = fr.run(u, lane_values, check=False)
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("the base power-up window is not finite")
    return state


def _window(fr, u, lane_values, state):
    torch.cuda.synchronize(fr.device)
    t0 = time.perf_counter()
    y, state, info = fr.run(u, lane_values, state=state, check=False)
    torch.cuda.synchronize(fr.device)
    return y, state, info, time.perf_counter() - t0


def measure(fr, u, lane_values, state0, reps=REPS, keep=()):
    """One warm window and ``reps`` timed chained windows of ``fr`` from
    ``state0``.  Returns a dict: ``rt`` (audio seconds over the timed
    windows' mean wall seconds), ``secs`` (every window's), the last
    window's ``fails_mean`` / ``fails_max`` / ``floored`` /
    ``iters_per_sample`` (and ``evals``, per subsystem), ``finite``
    (every window's output), ``y`` (the last window's output 0, (L, T),
    on the device) and ``kept`` (each window's output 0 on the lanes
    ``keep``, host arrays)."""
    samples = u.shape[1]
    state, secs, kept, finite = state0, [], [], True
    for _ in range(1 + reps):
        y, state, info, sec = _window(fr, u, lane_values, state)
        secs.append(sec)
        finite = finite and bool(torch.isfinite(y).all())
        kept.append(y[list(keep), 0].cpu().numpy())
    fails = info.fails.double()
    evals = (info.iters.double().mean(0) / samples).tolist()
    wall = sum(secs[1:]) / reps
    return dict(rt=(samples / FS) / wall, secs=secs,
                fails_mean=float(fails.mean()), fails_max=int(fails.max()),
                floored=int(info.floored.sum()), evals=evals,
                iters_per_sample=sum(evals), finite=finite, y=y[:, 0],
                kept=kept)


def vs_base_db(y, y_base):
    """max |y - y_base| over the peak of y_base, in dB (_ablate.py)."""
    ref = max(float(y_base.abs().max()), 1e-12)
    return 20 * np.log10(float((y - y_base).abs().max()) / ref + 1e-300)


def row_line(name, r, db):
    return (f"  {name}: RT/lane {r['rt']:.2f}x  fails mean "
            f"{r['fails_mean']:.2f} max {r['fails_max']}  iters/sample "
            f"{r['iters_per_sample']:.2f}  vs-base {db:.1f} dB")


def order(names):
    """Rows in run order: ``base`` first (the others' accuracy reference),
    the skipped ones apart."""
    names = [n for n in names if n != "base"]
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        raise ValueError(f"unknown configuration(s) {unknown}; choose from "
                         f"{ROWS}")
    return (["base"] + [n for n in names if n not in SKIPPED],
            [n for n in names if n in SKIPPED])


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv) or ROWS
    if not torch.cuda.is_available():
        raise SystemExit("acme_tpu_torch.ablate needs a CUDA card")
    run, skipped = order(names)
    dev = torch.device("cuda", 0)
    lane_values, u = level_inputs()
    t0 = time.time()
    # every runner centres a copy of the model as built: the centering runs
    # the model's stateful host solvers, and equal copies give equal
    # coefficients, so equal configurations share one build
    model = sweeps.build_model("level", "chain", FS)
    print(f"model build {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    state0 = power_up(base_runner(copy.deepcopy(model), dev), lane_values,
                      u)
    print(f"base power-up {time.time() - t0:.1f}s", flush=True)
    results, y_base = {}, None
    for name in run:
        fr = FusedRunner(copy.deepcopy(model), lane_scale_idx=(0,),
                         device=dev, **row_kwargs(name))
        r = measure(fr, u, lane_values, state0)
        y = r.pop("y")
        if name == "base":
            y_base, db = y, float("nan")
        else:
            db = vs_base_db(y, y_base)
        results[name] = (r, db)
        print(row_line(name, r, db), flush=True)
    for name in skipped:
        print(f"  {name}: skipped ({SKIPPED[name]})", flush=True)
    print("\nsummary:")
    for name, (r, db) in results.items():
        print(f"  {name:10s} RT {r['rt']:5.2f}x  fails {r['fails_mean']:6.2f}"
              f"/{r['fails_max']:4d}  it/s {r['iters_per_sample']:5.2f}  "
              f"vs-base {db:6.1f} dB")
    return results


if __name__ == "__main__":
    main()
