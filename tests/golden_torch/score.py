#!/usr/bin/env python
"""The port's CPU runtimes against every golden trace, in dB.

    python tests/golden_torch/score.py

Prints, for each trace of tests/golden/ (the JAX package's seven) and of
tests/golden_torch/ (the main path's), each runtime's largest deviation
from the 50-digit output over the trace's peak: the host runtime
(``runtime.run``, residual tolerance 1e-13 as tests/test_golden.py sets
it) and the float64 scan engine's plain version (``compile_model(model,
device="cpu", tol=1e-12)``, the traces of one model and length as the
lanes of one batch); then the fused runner's plain version in the full
path's build (``sweeps.build_model("level", "full")``,
``sweeps.PRODUCTION``, input level 1.0) over the first 64 samples of
``superover.npz``.  Every run starts where its trace starts
(``acme_tpu_torch.utils.golden``'s ``host_start``, ``engine_start``,
``fused_start``).  tests/test_torch_golden.py holds the same numbers to
their bounds; ``chip_smoke.py``'s golden phase runs the kernels on the
same traces on the card.
"""
import copy
import glob
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(TESTS))

from acme_tpu_torch import FusedRunner, runtime               # noqa: E402
from acme_tpu_torch import models as TM                       # noqa: E402
from acme_tpu_torch import sweeps as S                        # noqa: E402
from acme_tpu_torch.engine import compile_model               # noqa: E402
from acme_tpu_torch.utils.golden import (engine_start,        # noqa: E402
                                         fused_start, host_start, trace_db)

FS = 44100
ENGINE_TOL = 1e-12
HOST_RESABSTOL = 1e-13
FULL_SAMPLES = 64

# each trace's model, by group: the committed seven as tests/test_golden.py
# builds them; the main path's on its model, those resumed from the
# engine's carry in a group (and an engine batch) of their own
COMMITTED = {"diodeclipper": "diodeclipper", "sallenkey": "sallenkey",
             "birdie": "birdie", "superover": "superover",
             "superover_pots_lo": "superover_pots",
             "superover_pots_mid": "superover_pots",
             "superover_pots_hi": "superover_pots"}
MAIN = sorted(os.path.basename(p)[:-4]
              for p in glob.glob(os.path.join(HERE, "*.npz")))
GROUP = {**COMMITTED, **{n: "main resumed" if "_from" in n else "main"
                         for n in MAIN}}


def trace(name):
    d = os.path.join(TESTS, "golden") if name in COMMITTED else HERE
    with np.load(os.path.join(d, f"{name}.npz")) as f:
        return dict(f)


def build_models():
    """One model per group; the three Super Overs' exact parts in worker
    processes."""
    full, pots, chain = S.build_models([S.model_spec("level", "full", FS),
                                        S.model_spec("pots", "full", FS),
                                        S.model_spec("pots", "chain", FS)])
    return {"diodeclipper": TM.diodeclipper_model(fs=FS),
            "sallenkey": TM.sallenkey_model(fs=FS),
            "birdie": TM.birdie_model(vol=0.8, fs=FS),
            "superover": full, "superover_pots": pots, "main": chain,
            "main resumed": chain}


def host_db(models, name):
    tr = trace(name)
    m = copy.deepcopy(models[GROUP[name]])
    host_start(m, tr)
    for s in m.solvers:
        s.set_resabstol(HOST_RESABSTOL)
    return trace_db(runtime.run(m, tr["u"]), tr["y"])


def engine_dbs(models, name):
    """{trace: dB} for ``name`` and the traces that share its model and
    length, run as the lanes of one batch; raises if a lane-sample did not
    converge."""
    u = trace(name)["u"]
    names = [n for n in GROUP if GROUP[n] == GROUP[name]
             and trace(n)["u"].shape == u.shape]
    trs = [trace(n) for n in names]
    cm = compile_model(copy.deepcopy(models[GROUP[name]]), tol=ENGINE_TOL,
                       device="cpu")
    y, _, info = cm.run(np.stack([t["u"] for t in trs]),
                        state=engine_start(cm, trs))
    if not bool(info.converged.all()):
        raise RuntimeError(f"engine on {names}: not converged")
    return {n: trace_db(y[j].numpy(), t["y"])
            for j, (n, t) in enumerate(zip(names, trs))}


def fused_full(models):
    """The full path's build on the first FULL_SAMPLES of
    ``superover.npz``: (dB, fails, floored)."""
    tr = trace("superover")
    fr = FusedRunner(copy.deepcopy(models["superover"]), lane_scale_idx=(0,),
                     device="cpu", **S.PRODUCTION)
    lv = np.ones((1, 1))
    y, _, info = fr.run(tr["u"][:, :FULL_SAMPLES], lv,
                        state=fused_start(fr, [tr], lv), check=False)
    return (trace_db(y[0].numpy(), tr["y"][:, :FULL_SAMPLES]),
            int(info.fails.sum()), int(info.floored.sum()))


def main():
    import torch
    torch.set_num_threads(1)
    t0 = time.time()
    models = build_models()
    print(f"models built in {time.time() - t0:.1f}s", flush=True)
    eng = {}
    for name in GROUP:
        if name not in eng:
            eng.update(engine_dbs(models, name))
    for name in GROUP:
        print(f"{name}: host {host_db(models, name):.1f} dB, engine plain "
              f"{eng[name]:.1f} dB", flush=True)
    db, fails, floored = fused_full(models)
    print(f"superover, fused full path's plain version, first "
          f"{FULL_SAMPLES} samples: {db:.1f} dB, fails {fails}, floored "
          f"{floored}")
    print(f"total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
