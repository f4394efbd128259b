"""Utilities: the units frontend, state checkpoints and the 50-digit golden
oracle (the port's copy of ``acme_tpu.utils``' ``units``, ``checkpoint``
and ``golden``)."""

from .checkpoint import load_state, save_state
from .golden import (MPX, engine_start, fused_point, fused_start, golden_run,
                     golden_steadystate, host_start, trace_db)
from .units import Quantity, Unit, UnitError, units

__all__ = ["Quantity", "Unit", "units", "UnitError",
           "save_state", "load_state",
           "MPX", "golden_run", "golden_steadystate", "trace_db",
           "host_start", "engine_start", "fused_start", "fused_point"]
