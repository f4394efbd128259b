"""Utilities: the units frontend (the port's copy of ``acme_tpu.utils``'s
``units``)."""

from .units import Quantity, Unit, UnitError, units

__all__ = ["Quantity", "Unit", "units", "UnitError"]
