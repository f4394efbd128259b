"""acme_tpu_torch: the acme_tpu runtimes on PyTorch and CUDA.

The port of ``acme_tpu`` to an NVIDIA H100.  It shares the model compiler
and the host runtime with ``acme_tpu`` (one ``DiscreteModel`` feeds both
packages) and replaces the TPU's fused Pallas kernel with a hand-written
CUDA kernel (``ops/csrc``), next to a plain torch version of the same step
that runs on CPU tensors.

    from acme_tpu.models import superover_model
    from acme_tpu_torch import FusedRunner
    fr = FusedRunner(superover_model(drive=None, tone=None, level=1.0,
                                     vb_source=True),
                     lane_input_idx=(1, 2), device="cuda")
    y, state, info = fr.run(u_time, lane_values)

This package imports torch and never jax.
"""

from __future__ import annotations

import importlib.util
import os

# ``acme_tpu/__init__.py`` imports jax to switch on its x64 mode unless
# ACME_TPU_X64=0.  That flag gates nothing but JAX's x64 mode, so where jax
# is not installed (the GPU machine) setting it is moot and lets the shared
# compiler import.  Where jax is installed it is left alone: setting it here
# would turn x64 off for any JAX code that later runs in this process.
def _jax_installed():
    try:
        return importlib.util.find_spec("jax") is not None
    except (ImportError, ValueError):   # an import hook that refuses jax
        return False


if not _jax_installed():
    os.environ.setdefault("ACME_TPU_X64", "0")

from .ops.fused import FusedInfo, FusedRunner  # noqa: E402

__all__ = ["FusedRunner", "FusedInfo"]
