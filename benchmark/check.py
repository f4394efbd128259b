"""What decides ``correct``: the program's outputs on a seeded sample of
lanes against the plain reference (``reference.py``), run from cold over
the same samples.

    y_ref = reference_outputs(cfg, traffic, seed, lanes, n_samples)
    numbers = compare(y_prog, y_ref, n_warmup)

The reference runs once the window has closed, its lanes split over a few
worker processes (each a plain numpy loop over the samples).  It imports
nothing of the program.
"""

from __future__ import annotations

import math
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from gen import Stream, lane_values
from reference import Reference, round_bf16

__all__ = ["reference_outputs", "compare", "verdict", "CHUNK", "CONTROL"]

# lanes per worker process; samples per reference call
LANES_PER_WORKER = 8
CHUNK = 4096
# the control: the reference in bfloat16, the precision below the
# configuration's float32, its Newton loop stopped at bfloat16's
# resolution of a few volts
CONTROL = dict(rounding=round_bf16, tol=2e-2, max_iter=8)


def _lane_kw(cfg):
    r = cfg["runner"]
    return dict(lane_input_idx=tuple(r.get("lane_input_idx", ())),
                lane_scale_idx=tuple(r.get("lane_scale_idx", ())))


def run_reference(cfg, stream_spec, seed, lane_vals, n_samples, kw=None):
    """The reference's outputs (L, ny, n_samples) for ``lane_vals`` over
    the stream's first ``n_samples`` samples, from cold."""
    ref = Reference(cfg["netlist"], cfg["fs"], lane_vals, **_lane_kw(cfg),
                    **(kw or {}))
    stream = Stream(stream_spec, seed, cfg["fs"])
    out = []
    for n0 in range(0, n_samples, CHUNK):
        n = min(CHUNK, n_samples - n0)
        out.append(ref.run(stream.block(n0, n)[None, :]))
    return np.concatenate(out, axis=2)


def _worker(args):
    return run_reference(*args)


def reference_outputs(cfg, traffic, seed, lanes, n_samples, workers=None,
                      kw=None):
    """The reference's outputs for the lanes ``lanes`` (indices into the
    cell's lane grid), in worker processes of ``LANES_PER_WORKER`` lanes
    each (``workers=0``: in this process); ``kw``: the Reference's
    keywords (``CONTROL`` for the control)."""
    vals = lane_values(traffic["lanes"], seed)[np.asarray(lanes)]
    chunks = [vals[i:i + LANES_PER_WORKER]
              for i in range(0, len(vals), LANES_PER_WORKER)]
    jobs = [(cfg, traffic["stream"], seed, c, n_samples, kw)
            for c in chunks]
    if workers is None:
        workers = min(len(jobs), max(1, (os.cpu_count() or 1) - 1))
    if workers == 0 or len(jobs) == 1:
        parts = [_worker(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            parts = list(ex.map(_worker, jobs))
    return np.concatenate(parts, axis=0)


def _db(err, peak):
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(np.isfinite(err), err, np.inf) / np.maximum(peak, 1e-300)
        return 20.0 * np.log10(np.maximum(r, 1e-30))


def compare(y_prog, y_ref, n_warmup):
    """The numbers compared, from the program's outputs ``y_prog`` and the
    reference's ``y_ref`` (lanes, ny, samples) over the same samples, the
    first ``n_warmup`` of them the warm-up's:

    ``window_err_db``: the worst lane's largest error over the window's
    samples, in dB of that lane's peak there;
    ``warmup_err_db``: the worst lane's largest error over the warm-up's
    samples, in dB of that lane's peak over all of them.
    A non-finite output reads +inf."""
    d = np.abs(np.asarray(y_prog, np.float64) - y_ref)
    d = np.where(np.isfinite(d), d, np.inf)
    peak_all = np.abs(y_ref).max(axis=(1, 2))
    w = slice(n_warmup, None)
    win = _db(d[:, :, w].max(axis=(1, 2)), np.abs(y_ref[:, :, w]).max(axis=(1, 2)))
    warm = _db(d[:, :, :n_warmup].max(axis=(1, 2)), peak_all)
    lane = int(np.argmax(win))
    return {"window_err_db": float(np.max(win)),
            "warmup_err_db": float(np.max(warm)),
            "worst_lane": lane,
            "worst_sample": int(n_warmup + np.argmax(d[lane, :, w].max(0)))}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): each number with a limit in
    ``limits`` must not exceed it."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        if v is None or not (v <= limit):
            ok = False
        rows.append((name, v, limit))
    return ok, rows
