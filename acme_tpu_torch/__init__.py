"""acme_tpu_torch: the acme_tpu runtimes on PyTorch and CUDA.

The port of ``acme_tpu`` to an NVIDIA H100.  It carries its own copy of the
model compiler and the host runtime (``circuit``, ``element``,
``elements``, ``exact``, ``model``, ``models``, ``runtime``, ``solvers``,
``kdtree``: numpy only, the same code and names as in ``acme_tpu``) and
replaces the TPU's fused Pallas kernel, and the float64 scan engine's XLA
program, with hand-written CUDA kernels (``ops/csrc``), each next to a
plain torch version of the same step that runs on CPU tensors.

    from acme_tpu_torch.models import superover_model
    from acme_tpu_torch import FusedRunner
    fr = FusedRunner(superover_model(drive=None, tone=None, level=1.0,
                                     vb_source=True),
                     lane_input_idx=(1, 2), device="cuda")
    y, state, info = fr.run(u_time, lane_values)

    from acme_tpu_torch import compile_model   # the float64 scan engine
    y, state, info = compile_model(model).run(u)   # u (nu, T) or (L, nu, T)

This package imports torch and numpy, never jax and nothing of
``acme_tpu``.
"""

from __future__ import annotations

from .circuit import Circuit, composite_element, parse_netlist
from .element import Element, NLFunc
from .elements import (bjt, capacitor, currentprobe, currentsource, diode,
                       inductor, mosfet, opamp, potentiometer, resistor,
                       transformer, voltageprobe, voltagesource)
from .engine import (BatchCompiledModel, CompiledModel, RunInfo,
                     compile_model, compile_models)
from .model import DiscreteModel
from .ops.fused import FusedInfo, FusedRunner
from .runtime import (ModelRunner, linearize, run, steadystate,
                      steadystate_, steadystate_sweep)
from .solvers import (CachingSolver, HomotopySolver, SimpleSolver,
                      default_solver, homotopy_simple_solver)

__all__ = [
    "FusedRunner", "FusedInfo",
    "compile_model", "compile_models", "CompiledModel",
    "BatchCompiledModel", "RunInfo",
    "Circuit", "parse_netlist", "composite_element",
    "Element", "NLFunc", "DiscreteModel",
    "resistor", "potentiometer", "capacitor", "inductor", "transformer",
    "voltagesource", "currentsource", "voltageprobe", "currentprobe",
    "diode", "bjt", "mosfet", "opamp",
    "run", "ModelRunner", "steadystate", "steadystate_",
    "steadystate_sweep", "linearize",
    "SimpleSolver", "HomotopySolver", "CachingSolver",
    "default_solver", "homotopy_simple_solver",
]
