"""Execute docs/gpu.md's fenced python blocks on the CPU, so that the GPU
guide cannot rot (tests/test_docs.py does the same for docs/tpu.md).

The blocks share one namespace, in order.  They run on the card in the
guide; here ``acme_tpu_torch.FusedRunner`` is a subclass that forces
``device="cpu"`` (the plain torch version of the kernel's step),
``compile_model`` passes ``device="cpu"`` (the plain scan) and
``parallel.lane_mesh()`` returns two CPU entries.  Sizes shrink by a
light source rewrite: 1-s windows (44100 samples) to 16 samples (the
plain fused step takes some 0.2 s a sample for 128 lanes on one CPU
core), the 4096 lanes of a sweep to 256 (two lane blocks, one for each
mesh entry) and the main path's lanes to every 512th of its grid.  Then
the shapes the guide promises, at those sizes.
"""

import re
from pathlib import Path

import numpy as np
import torch

import acme_tpu_torch
import acme_tpu_torch.parallel

GUIDE = Path(__file__).resolve().parent.parent / "docs" / "gpu.md"
T = 16
REWRITES = (("np.arange(44100)", f"np.arange({T})"),
            ("np.linspace(0.05, 0.95, 4096)", "np.linspace(0.05, 0.95, 256)"),
            ("lanes = np.arange(4096)", "lanes = np.arange(0, 4096, 512)"),
            ("cm.initial_state(4096)", "cm.initial_state(256)"))


class CpuRunner(acme_tpu_torch.FusedRunner):
    def __init__(self, model, *args, **kw):
        kw["device"] = "cpu"
        super().__init__(model, *args, **kw)


def cpu_compile_model(model, **kw):
    return acme_tpu_torch.engine.compile_model(model, **{**kw,
                                                         "device": "cpu"})


def test_gpu_guide_blocks_run(monkeypatch):
    blocks = re.findall(r"```python\n(.*?)```", GUIDE.read_text(), re.S)
    assert len(blocks) >= 6, "gpu.md lost its python examples"
    monkeypatch.chdir(GUIDE.parent.parent)   # the guide's paths: the repo's
    monkeypatch.setattr(acme_tpu_torch, "FusedRunner", CpuRunner)
    monkeypatch.setattr(acme_tpu_torch, "compile_model", cpu_compile_model)
    monkeypatch.setattr(acme_tpu_torch.parallel, "lane_mesh",
                        lambda *a, **k: (torch.device("cpu"),) * 2)
    ns = {}
    for src in blocks:
        for old, new in REWRITES:
            src = src.replace(old, new)
        exec(compile(src, "gpu.md", "exec"), ns)
    L = 256
    assert tuple(ns["y"].shape) == (L, 1, T)
    assert tuple(ns["info"].fails.shape) == (L,)
    assert tuple(ns["y_main"].shape) == (8, 1, T)
    assert ns["fg"].group_size(4096) == 2048
    assert tuple(ns["y_mesh"].shape) == (L, 1, T)
    assert tuple(ns["y64"].shape) == (L, 1, T)
    assert bool(ns["info64"].converged.all())
    assert tuple(ns["y1"].shape) == (1, T)
    assert tuple(ns["y_next"].shape) == (L, 1, T)
    assert ns["y_gold"].shape == (1, 32)
    assert ns["trace_db"](ns["y_eng"].numpy(), ns["y_gold"]) < -110
    for key in ("y", "y_main", "y_mesh", "y64", "y_next"):
        assert bool(torch.isfinite(ns[key]).all()), key
