"""Minimal physical-units frontend for element parameters.

The port's own copy of ``acme_tpu/utils/units.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Counterpart of the reference's Unitful extension (ref ext/UnitfulExt.jl):
every element constructor accepts plain numbers or :class:`Quantity` values;
quantities are validated against the expected dimension and stripped to SI
floats.  Implemented internally (no pint dependency): a Quantity is a float
plus an exponent vector over the SI base dimensions (m, kg, s, A).

Usage::

    from acme_tpu_torch.utils.units import units as U
    resistor(4.7 * U.kohm)
    capacitor(22 * U.nF)
    voltagesource(9 * U.V)
    check_unit(x, U.ohm)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["Quantity", "Unit", "units", "UnitError", "magnitude",
           "magnitude_poly"]

Dims = Tuple[int, int, int, int]  # exponents of (m, kg, s, A)


class UnitError(TypeError):
    pass


@dataclass(frozen=True)
class Quantity:
    value: float
    dims: Dims

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value,
                            tuple(a + b for a, b in zip(self.dims, other.dims)))
        return Quantity(self.value * other, self.dims)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value / other.value,
                            tuple(a - b for a, b in zip(self.dims, other.dims)))
        return Quantity(self.value / other, self.dims)

    def __rtruediv__(self, other):
        return Quantity(other / self.value, tuple(-d for d in self.dims))

    def __add__(self, other):
        if not isinstance(other, Quantity) or other.dims != self.dims:
            raise UnitError("cannot add quantities of different dimensions")
        return Quantity(self.value + other.value, self.dims)

    def __neg__(self):
        return Quantity(-self.value, self.dims)

    def __pow__(self, n):
        return Quantity(self.value ** n, tuple(d * n for d in self.dims))

    def __float__(self):
        if any(self.dims):
            raise UnitError(f"quantity is not dimensionless: {self}")
        return float(self.value)

    def to(self, unit: "Quantity") -> float:
        """Value expressed in ``unit``; raises on dimension mismatch."""
        if self.dims != unit.dims:
            raise UnitError(f"dimension mismatch: {self.dims} vs {unit.dims}")
        return self.value / unit.value

    def __repr__(self):
        return f"Quantity({self.value}, dims={self.dims})"


Unit = Quantity

_D0: Dims = (0, 0, 0, 0)


def _u(value, m=0, kg=0, s=0, A=0) -> Quantity:
    return Quantity(value, (m, kg, s, A))


class _Units:
    """SI units and common prefixes for circuit work."""

    # base / derived
    m = _u(1.0, m=1)
    m2 = _u(1.0, m=2)
    s = _u(1.0, s=1)
    A = _u(1.0, A=1)
    V = _u(1.0, m=2, kg=1, s=-3, A=-1)
    ohm = _u(1.0, m=2, kg=1, s=-3, A=-2)
    S = _u(1.0, m=-2, kg=-1, s=3, A=2)   # siemens
    F = _u(1.0, m=-2, kg=-1, s=4, A=2)
    H = _u(1.0, m=2, kg=1, s=-2, A=-2)
    Hz = _u(1.0, s=-1)
    A_per_m = _u(1.0, m=-1, A=1)
    A_per_V2 = _u(1.0, m=-4, kg=-2, s=6, A=3)  # A / V^2
    per_V = _u(1.0, m=-2, kg=-1, s=3, A=1)     # 1 / V
    one = _u(1.0)

    def __init__(self):
        prefixes = {"G": 1e9, "M": 1e6, "k": 1e3, "m": 1e-3, "u": 1e-6,
                    "n": 1e-9, "p": 1e-12, "f": 1e-15}
        for base in ("ohm", "V", "A", "F", "H", "S", "Hz", "m"):
            q = getattr(self, base)
            for pre, scale in prefixes.items():
                setattr(self, pre + base, q * scale)


units = _Units()

_EXPECTED = {
    "resistance": units.ohm.dims,
    "capacitance": units.F.dims,
    "inductance": units.H.dims,
    "voltage": units.V.dims,
    "current": units.A.dims,
    "conductance": units.S.dims,
    "length": units.m.dims,
    "area": units.m2.dims,
    "field": units.A_per_m.dims,
    "transconductance": units.A_per_V2.dims,
    "inverse_voltage": units.per_V.dims,
    "dimensionless": _D0,
}


def magnitude_poly(x, kind: str, degree: int):
    """Strip units from the degree-``degree`` coefficient of a polynomial in
    a voltage: the expected dimension is ``kind`` / V**degree, e.g. a mosfet
    threshold polynomial vt = (vt0, vt1, vt2) has units (V, dimensionless,
    1/V) (ref ext/UnitfulExt.jl:89-91)."""
    if isinstance(x, Quantity):
        base = _EXPECTED[kind]
        vd = units.V.dims
        exp = tuple(b - degree * v for b, v in zip(base, vd))
        if x.dims != exp:
            raise UnitError(
                f"expected {kind}/V^{degree} ({exp}), got dimensions "
                f"{x.dims}")
        return float(x.value)
    return float(x)


def magnitude(x, kind: str = None):
    """Strip units.  Plain numbers pass through; a Quantity must match the
    expected ``kind`` (one of the keys above) and yields its SI value.
    Mirrors the validate-and-strip behaviour of ext/UnitfulExt.jl."""
    if isinstance(x, Quantity):
        if kind is not None:
            exp = _EXPECTED[kind]
            if x.dims != exp:
                raise UnitError(
                    f"expected {kind} ({exp}), got dimensions {x.dims}")
        elif any(x.dims):
            raise UnitError(f"expected a dimensionless value, got {x.dims}")
        return float(x.value)
    return float(x)
