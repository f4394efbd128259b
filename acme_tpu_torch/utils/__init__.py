"""Utilities: the units frontend and state checkpoints (the port's copy of
``acme_tpu.utils``' ``units`` and ``checkpoint``)."""

from .checkpoint import load_state, save_state
from .units import Quantity, Unit, UnitError, units

__all__ = ["Quantity", "Unit", "units", "UnitError",
           "save_state", "load_state"]
