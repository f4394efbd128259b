#!/usr/bin/env python3
"""The benchmark of acme_tpu_torch: one cell of ``BENCHMARK.json``, one run.

    python3 benchmark/run.py --workload full_level --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout, on a machine with a CUDA card.  Set-up builds
the cell's model with the port's compiler, prepares its ``FusedRunner``
and warms it up from cold (the power-up block, then one production
block); the window then runs ``FusedRunner.run`` block after block, the
state carried, for ``--seconds`` seconds.  After the window a seeded
sample of lanes is checked against the plain reference (``check.py``).
The last line of standard output is the result: ``correct``,
``attempted`` (the window's lane-samples), ``failed`` (the lane-samples
on which ``FusedInfo.fails`` counts a subsystem that missed its gate,
those with a non-finite output, and every one of a call that raised),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py``), ``device``, with
``--trace 1`` a ``breakdown``, and ``check``: each number compared with
its limit.

Everything a cell needs is data: ``configs/<config>.json`` (the model's
keywords, the runner's, the dimensions, the netlist the reference reads),
``traffic/<traffic>.json`` (lanes, block size, warm-up, stream, check) and
the readers under ``metrics/``.  The port's kernel builds go to
``benchmark/.build`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(HERE, ".build")
# top-level module names that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "acme_tpu")


def _environment():
    """Fixed cache directories inside the checkout, one thread for the
    host's numerical libraries, and no JAX through a library."""
    os.environ["ACME_TPU_TORCH_BUILD"] = BUILD
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_ext")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(k, "1")
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_cell(workload, root=ROOT):
    """(BENCHMARK.json, its workload entry, the configuration, the traffic
    file) for ``workload``; the metric entries the cell reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return spec, cell, cfg, traffic


def cell_metrics(spec, cell, trace):
    """The metric entries that ``cell`` reports in a run with ``trace``."""
    rows = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in rows if cell["name"] in m.get("workloads",
                                                     [cell["name"]])]


def load_reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Run:
    """What the metric readers read: spans (seconds), the window's blocks
    (wall seconds and kernel ms per call), counters and the fixed work."""

    def __init__(self):
        self.spans = {}
        self.blocks = []
        self.window_s = 0.0
        self.lane_samples = 0
        self.iters = None
        self.fails = 0
        self.nonfinite = 0
        self.lost = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.peaks = None
        self.trace = None


class Port:
    """The system under test: ``acme_tpu_torch.FusedRunner`` over the
    configuration's Super Over model."""

    def __init__(self, cfg, spans, device):
        from acme_tpu_torch import FusedRunner
        from acme_tpu_torch.models import superover_model
        from acme_tpu_torch.ops import fused
        self.fused = fused
        t = time.perf_counter()
        model = superover_model(**cfg["model"], fs=cfg["fs"])
        spans["model_build"] = time.perf_counter() - t
        dims = {"nx": model.nx, "nu": model.nu, "ny": model.ny,
                "nn": [model.nn(k) for k in range(model.nsubsystems)],
                "np": [model.np(k) for k in range(model.nsubsystems)],
                "nq": [model.nq(k) for k in range(model.nsubsystems)]}
        if dims != cfg["dims"]:
            raise SystemExit(f"the port's model has dimensions {dims}, the "
                             f"configuration states {cfg['dims']}")
        t = time.perf_counter()
        self.runner = FusedRunner(model, device=device, **cfg["runner"])
        spans["runner_prep"] = time.perf_counter() - t

    def run(self, u, lanes, state):
        return self.runner.run(u[None, :], lanes, state=state)

    def time_launches(self, on):
        self.fused.LAUNCH_EVENTS = [] if on else None

    def launches(self):
        return self.fused.LAUNCH_EVENTS


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def bench(args, spec, cell, cfg, traffic, make_program=Port,
          device="cuda", workers=None, log=print):
    """One run of ``cell``: returns the result line's object."""
    import torch

    import check
    import gen
    import work
    run = Run()
    trace = bool(args.trace)
    fs = cfg["fs"]
    T = int(traffic["block"])
    lanes = gen.lane_values(traffic["lanes"], args.seed)
    L = lanes.shape[0]
    chk = gen.check_lanes(L, int(traffic["check"]["lanes"]), args.seed)
    stream = gen.Stream(traffic["stream"], args.seed, fs)
    warm = traffic["warmup"]
    if int(warm["powerup_block"]) != int(cfg["runner"]["powerup_samples"]):
        raise SystemExit("the warm-up's first block must be the power-up "
                         "sibling's whole window")
    raised = 0
    kept = []
    n0 = n_warm = 0
    prof = None
    dev = torch.device(device)
    idx = torch.as_tensor(chk, device=dev)
    prog = None
    state = None
    # the window's counters: Newton evaluations, lane-samples that missed
    # a gate, lane-samples with a non-finite output
    iters = torch.zeros((), dtype=torch.float64, device=dev)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

    def tally(y, info):
        iters.add_(info.iters.sum())
        fails.add_(info.fails.sum())
        nonfinite.add_((~torch.isfinite(y)).any(dim=1).sum())
        kept.append(y.index_select(0, idx))

    run.spans["before_model"] = time.perf_counter() - T_START
    try:
        prog = make_program(cfg, run.spans, device)
        t = time.perf_counter()
        sizes = [int(warm["powerup_block"])] + [T] * int(warm["blocks"])
        for n in sizes:
            t0 = time.perf_counter()
            y, state, info = prog.run(stream.block(n0, n), lanes, state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tally(y, info)             # the window's tally ops, warmed up
            n0 += n
        for c in (iters, fails, nonfinite):
            c.zero_()
        t1 = time.perf_counter()
        run.spans["warmup"] = t1 - t
        n_warm = n0
        # the window's inputs, made ahead: enough blocks for twice the
        # rate of the warm-up's last block, more if that runs out
        per_block = max(t1 - t0, 1e-3)
        n_ahead = int(args.seconds / per_block * 2) + 8
        inputs = [stream.block(n0 + i * T, T) for i in range(n_ahead)]
        run.spans["inputs"] = time.perf_counter() - t1
        span = contextlib.nullcontext
        if trace:
            prog.time_launches(True)
            from torch.profiler import ProfilerActivity, profile
            span = torch.profiler.record_function
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        run.spans["setup"] = time.perf_counter() - T_START
        t_win = time.perf_counter()
        i = 0
        while True:
            u = inputs[i] if i < len(inputs) else stream.block(n0, T)
            mark = len(prog.launches()) if trace else 0
            t0 = time.perf_counter()
            run.lost = L * T           # until the call returns
            with span("FusedRunner.run"):
                y, state, info = prog.run(u, lanes, state)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            run.lost = 0
            run.blocks.append({"wall_s": t1 - t0, "launches": (
                mark, len(prog.launches())) if trace else None})
            with span("harness"):
                tally(y, info)
            n0 += T
            i += 1
            if t1 - t_win >= args.seconds:
                break
        run.window_s = t1 - t_win
        if prof is not None:
            prof.__exit__(None, None, None)
        if trace:
            ev = prog.launches()
            for b in run.blocks:
                a, z = b["launches"]
                b["kernel_ms"] = sum(e0.elapsed_time(e1) for e0, e1 in ev[a:z])
            prog.time_launches(False)
        run.iters = float(iters.item())
        run.fails = int(fails.item())
        run.nonfinite = int(nonfinite.item())
    except Exception:                  # the program failed: report it
        traceback.print_exc()
        raised = 1
        if prof is not None:
            prof.__exit__(None, None, None)
            prof = None
    run.lane_samples = L * T * len(run.blocks)
    # the lane-samples of a window's call that raised count as attempted
    # and failed
    attempted = run.lane_samples + run.lost
    failed = run.fails + run.nonfinite + run.lost
    mem = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    if trace and prof is not None:
        import devtrace
        busy, ops, gaps = devtrace.reduce(
            prof.events(), skip=("FusedRunner.run", "harness"))
        run.trace = {"busy_s": busy, "device_ops": ops, "idle_gaps": gaps}
    y_prog = torch.cat(kept, dim=2).float().cpu().numpy() if kept else None
    del prog, state, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference, over every sample the program ran on the check lanes
    numbers = {"raised": raised}
    if y_prog is not None and y_prog.shape[2] > n_warm:
        t = time.perf_counter()
        y_ref = check.reference_outputs(cfg, traffic, args.seed, chk,
                                        y_prog.shape[2], workers=workers)
        numbers.update(check.compare(y_prog, y_ref, n_warm))
        run.spans["reference"] = time.perf_counter() - t
    else:
        numbers.update(window_err_db=math.inf, warmup_err_db=math.inf)
    correct, rows = check.verdict(numbers, traffic["check"]["limits"])
    # the fixed work and the peaks
    run.flops = work.flops_per_lane_sample(cfg["dims"],
                                           cfg["nonlinear_elements"]) \
        * run.lane_samples
    time_rows = cfg["dims"]["nu"] - len(cfg["runner"].get("lane_input_idx",
                                                          ()))
    run.bytes = len(run.blocks) * work.block_bytes(
        cfg["dims"], L, T, lanes.shape[1], time_rows)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run.peaks = work.peaks(kind)
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": kind, "count": int(cell.get("chips", 1)),
               "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": devinfo}
    if trace:
        devinfo["busy_s"] = run.trace["busy_s"] if run.trace else 0.0
        devinfo["window_s"] = run.window_s
        if run.trace and run.trace["device_ops"]:
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in run.trace["device_ops"]],
                "idle_gaps": [[n, s] for n, s in run.trace["idle_gaps"]]}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    log(f"# cell {cell['name']} seed {args.seed} lanes {L} block {T} "
        f"blocks {len(run.blocks)} window_s {run.window_s:.6f} "
        f"warmup_samples {n_warm} check_lanes {len(chk)} "
        f"spans {json.dumps(run.spans)} iters {run.iters} "
        f"worst_lane {chk[numbers['worst_lane']] if 'worst_lane' in numbers else None} "
        f"worst_sample {numbers.get('worst_sample')}")
    return result, rows


def main(argv=None):
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec, cell, cfg, traffic = load_cell(args.workload)
    for m in cell_metrics(spec, cell, args.trace):
        if not os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")):
            raise SystemExit(f"no reader metrics/{m['name']}.py")
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(2)
    import acme_tpu_torch  # noqa: F401  (fails here without the port)
    print(f"# card {power_limit()}; peaks: see benchmark/peaks.json",
          flush=True)
    result, rows = bench(args, spec, cell, cfg, traffic)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
