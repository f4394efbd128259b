"""The port imports torch and never jax, nothing of acme_tpu, no bench.

A subprocess whose meta-path finder refuses every ``jax``, ``acme_tpu`` and
``bench`` import (on the GPU machine jax is not installed, and the port
carries its own compiler) imports acme_tpu_torch and all its modules,
builds the diode clipper with the port's compiler, runs the plain path on
128 lanes x 32 samples with the level sweep's lane-scaled input and
two-phase power-up, runs the float64 scan engine's plain version on it
(``engine``, ``ops.newton``, ``ops.linsolve``) and checkpoints its state
(``utils.checkpoint``), and checks that none of those modules was
loaded.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    REFUSED = ("jax", "jaxlib", "acme_tpu", "bench")

    def refused(name):
        return name.split(".")[0] in REFUSED

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if refused(name):
                raise ModuleNotFoundError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import pkgutil
    import numpy as np
    import acme_tpu_torch
    for mod in pkgutil.walk_packages(acme_tpu_torch.__path__,
                                     "acme_tpu_torch."):
        __import__(mod.name)
    import acme_tpu_torch.ablate
    import acme_tpu_torch.engine
    import acme_tpu_torch.ops.linsolve
    import acme_tpu_torch.ops.newton
    import acme_tpu_torch.parallel
    import acme_tpu_torch.utils.checkpoint
    from acme_tpu_torch.models import diodeclipper_model
    from acme_tpu_torch.sweeps import PRODUCTION
    fr = acme_tpu_torch.FusedRunner(diodeclipper_model(),
                                    lane_scale_idx=(0,), powerup="safe",
                                    powerup_samples=16, **PRODUCTION,
                                    device="cpu")
    u = (1.5 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(32)))[None, :]
    y, state, info = fr.run(u, np.linspace(0.1, 2.0, 128)[:, None])
    assert tuple(y.shape) == (128, 1, 32)
    assert bool(np.isfinite(y.numpy()).all())
    assert int(info.fails.sum()) == 0
    import os, tempfile
    cm = acme_tpu_torch.compile_model(diodeclipper_model(), device="cpu")
    y, st, info = cm.run(u)
    assert tuple(y.shape) == (1, 32) and bool(info.converged.all())
    path = os.path.join(tempfile.mkdtemp(), "state.npz")
    acme_tpu_torch.utils.checkpoint.save_state(path, st)
    back = acme_tpu_torch.utils.checkpoint.load_state(path,
                                                      cm.initial_state(1))
    assert bool((back["x"] == st["x"]).all())
    loaded = [m for m in sys.modules if refused(m)]
    assert not loaded, loaded
    print("OK")
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("ACME_TPU_X64", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
