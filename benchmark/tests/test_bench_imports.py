"""The import rule, in fresh processes (the repository's root conftest.py
imports jax into this one): the harness and its modules load nothing
whose top-level name is jax, jaxlib, flax or acme_tpu, and the reference's
modules load nothing of the program, acme_tpu_torch."""

import json
import os
import subprocess
import sys

import bench_cells as bc

PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import importlib
for name in {mods!r}:
    importlib.import_module(name)
if {port!r}:
    import acme_tpu_torch, acme_tpu_torch.ops.fused  # noqa: F401
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def _tops(mods, port=False):
    code = PROBE.format(bench=bc.BENCH, root=bc.ROOT, mods=mods, port=port)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=bc.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _readers():
    return ["metrics." + f[:-3] for f in
            sorted(os.listdir(os.path.join(bc.BENCH, "metrics")))
            if f.endswith(".py")]


def test_harness_loads_no_jax_nor_the_jax_package():
    tops = _tops(["run", "check", "gen", "reference", "work", "devtrace"]
                 + _readers(), port=True)
    assert "acme_tpu_torch" in tops      # compared as whole names
    assert not tops & {"jax", "jaxlib", "flax", "acme_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = _tops(["reference", "check", "gen", "work"])
    assert not tops & {"acme_tpu_torch", "acme_tpu", "jax", "jaxlib",
                       "torch"}


def test_forbidden_names_compare_whole():
    sys.path.insert(0, bc.BENCH)
    import run
    saved = dict(sys.modules)
    try:
        for k in [k for k in sys.modules
                  if k.partition(".")[0] in run.FORBIDDEN]:
            del sys.modules[k]
        sys.modules["acme_tpu_torch_fake"] = object()
        assert run.forbidden_modules() == []
        sys.modules["jaxlib.fake"] = object()
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
