"""The port imports torch and never jax.

A subprocess whose meta-path finder refuses every ``jax`` import (as on
the GPU machine, where jax is not installed) imports acme_tpu_torch,
builds the diode clipper with the shared compiler, runs the plain path on
128 lanes x 32 samples, and checks that no jax module was loaded.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ModuleNotFoundError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, RefuseJax())
    import numpy as np
    import acme_tpu_torch
    from acme_tpu.models import diodeclipper_model
    fr = acme_tpu_torch.FusedRunner(diodeclipper_model())
    u = (1.5 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(32)))[None, :]
    y, state, info = fr.run(u, np.zeros((128, 0)))
    assert tuple(y.shape) == (128, 1, 32)
    assert bool(np.isfinite(y.numpy()).all())
    assert int(info.fails.sum()) == 0
    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
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
