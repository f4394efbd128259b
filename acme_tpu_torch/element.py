"""Circuit element representation.

The port's own copy of ``acme_tpu/element.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

An element contributes ``nl`` equation rows
``mv@v + mi@i + mx@x + mxd@xdot + mq@q + mu@u = u0`` over its ``nb`` branches,
``nx`` states, ``nq`` nonlinear-function arguments and the circuit inputs,
plus ``ny`` output rows ``y = pv@v + pi@i + px@x + pxd@xdot + pq@q``.
``nn = nb + nx + nq - nl`` is the number of nonlinear unknowns the element
introduces.  This mirrors the Element contract of the reference
(ACME.jl/src/ACME.jl:21-113) with coefficient matrices stored as
exact rationals and the nonlinearity as a pure, trace-friendly function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .exact import fmat, fzeros

__all__ = ["Element", "NLFunc"]

_MAT_DIMS = {
    "mv": ("nl", "nb"), "mi": ("nl", "nb"), "mx": ("nl", "nx"),
    "mxd": ("nl", "nx"), "mq": ("nl", "nq"), "mu": ("nl", "nu"),
    "u0": ("nl", "n0"),
    "pv": ("ny", "nb"), "pi": ("ny", "nb"), "px": ("ny", "nx"),
    "pxd": ("ny", "nx"), "pq": ("ny", "nq"),
}


@dataclass(frozen=True)
class NLFunc:
    """A nonlinear residual with analytic Jacobian.

    ``fn(xp, q)`` maps a length-``nq`` vector to ``(res, J)`` with shapes
    ``(nn,)`` and ``(nn, nq)``.  ``xp`` is the array namespace (``numpy`` for
    the host reference runtime, ``jax.numpy`` for the TPU runtime), so each
    device model is written exactly once and is traceable by JAX.
    """
    nn: int
    nq: int
    fn: Callable
    #: optional hashable signature of the parameters captured by ``fn``;
    #: two NLFuncs with different closures but equal (nn, nq, sig) compare
    #: equal for Element identity purposes (e.g. two diode(is_=1e-12))
    sig: Optional[tuple] = None

    def __call__(self, xp, q):
        return self.fn(xp, q)

    def same_behavior(self, other: "NLFunc") -> bool:
        if (self.nn, self.nq) != (other.nn, other.nq):
            return False
        if self.fn is other.fn:
            return True
        if self.sig is not None and other.sig is not None:
            return self.sig == other.sig
        return False


def _norm_pin(p) -> str:
    return str(p)


class Element:
    """A circuit element: 12 exact coefficient matrices + optional nonlinearity.

    Matrices may be passed as scalars, nested lists or arrays; missing ones
    default to zero with consistent sizes (ref ACME.jl:29-55).  ``ports`` is a
    list of ``(pos_pin, neg_pin)`` pairs, one per branch; alternatively a
    ``pins`` dict ``{name: [(branch, polarity), ...]}`` may be given.  By
    default branch ``b`` gets pins ``2b-1`` (positive) and ``2b`` (negative).
    """

    __slots__ = ("mats", "sizes", "nonlinear_eq", "pins")

    def __init__(self, *, nonlinear_eq: Optional[NLFunc] = None,
                 ports=None, pins=None, **mat_args):
        mats: Dict[str, np.ndarray] = {}
        sizes: Dict[str, int] = {"n0": 1}
        for name, val in mat_args.items():
            if name not in _MAT_DIMS:
                raise TypeError(f"unknown element matrix {name!r}")
            if val is None:
                continue
            m = fmat(val)
            for sym, s in zip(_MAT_DIMS[name], m.shape):
                if sizes.setdefault(sym, s) != s:
                    raise ValueError(f"Inconsistent sizes for {sym}")
            mats[name] = m
        for name, (rs, cs) in _MAT_DIMS.items():
            if name not in mats:
                mats[name] = fzeros(sizes.setdefault(rs, 0), sizes.setdefault(cs, 0))
        self.mats = mats
        self.sizes = sizes
        if nonlinear_eq is None:
            nonlinear_eq = NLFunc(nn=0, nq=self.nq, fn=_empty_nl)
        self.nonlinear_eq = nonlinear_eq

        if ports is not None:
            pd: Dict[str, List[Tuple[int, int]]] = {}
            for branch, (pp, pn) in enumerate(ports):
                pd.setdefault(_norm_pin(pp), []).append((branch, 1))
                pd.setdefault(_norm_pin(pn), []).append((branch, -1))
            pins = pd
        if pins is None:
            pins = {}
            for b in range(self.nb):
                pins[_norm_pin(2 * b + 1)] = [(b, 1)]
                pins[_norm_pin(2 * b + 2)] = [(b, -1)]
        else:
            pins = {_norm_pin(k): list(v) for k, v in pins.items()}
        self.pins = pins

    # dimension getters (ref ACME.jl:105-110)
    @property
    def nb(self) -> int:
        return self.mats["mv"].shape[1]

    @property
    def nx(self) -> int:
        return self.mats["mx"].shape[1]

    @property
    def nq(self) -> int:
        return self.mats["mq"].shape[1]

    @property
    def nu(self) -> int:
        return self.mats["mu"].shape[1]

    @property
    def nl(self) -> int:
        return self.mats["mv"].shape[0]

    @property
    def ny(self) -> int:
        return self.mats["pv"].shape[0]

    @property
    def nn(self) -> int:
        return self.nb + self.nx + self.nq - self.nl

    def __getattr__(self, name):
        # convenient matrix access: elem.mv, elem.pq, ...
        mats = object.__getattribute__(self, "mats")
        if name in mats:
            return mats[name]
        raise AttributeError(name)

    def __eq__(self, other):
        if not isinstance(other, Element):
            return NotImplemented
        if self.pins != other.pins:
            return False
        if self.nonlinear_eq is not other.nonlinear_eq and \
                not self.nonlinear_eq.same_behavior(other.nonlinear_eq):
            return False
        for k in _MAT_DIMS:
            a, b = self.mats[k], other.mats[k]
            if a.shape != b.shape or not (a == b).all():
                return False
        return True

    def __repr__(self):
        return (f"Element(nb={self.nb}, nx={self.nx}, nq={self.nq}, nu={self.nu}, "
                f"nl={self.nl}, ny={self.ny}, nn={self.nn})")


def _empty_nl(xp, q):
    res = xp.zeros((0,), dtype=getattr(q, "dtype", None) or float)
    J = xp.zeros((0, q.shape[0] if hasattr(q, "shape") else 0), dtype=getattr(q, "dtype", None) or float)
    return res, J
