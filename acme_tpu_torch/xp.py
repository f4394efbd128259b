"""A torch array namespace for the element library's ``nl(xp, q)`` closures.

The element physics (``acme_tpu.elements``) is written once against an
array namespace ``xp`` with a numpy-like surface (``acme_tpu/circuit.py``
composes it per subsystem).  This module maps that surface onto torch so
the same closures evaluate on tensors, in float32 or float64, on any
device:

    res, Jq = model.nl_funcs[k](acme_tpu_torch.xp, q)   # q: (nq, ...) tensor

Two differences from torch's own functions are absorbed here:

* ``minimum``/``maximum`` accept a Python scalar operand (``_exp`` calls
  ``xp.minimum(arg, 73.0)``), which ``torch.minimum`` rejects; the scalar
  takes the tensor's dtype, as a weakly typed scalar does in numpy/JAX.
* ``zeros(shape, dtype=...)`` takes a torch dtype (``J.dtype``) or none.
  It allocates on torch's default device, so callers evaluating on a
  card wrap the call in ``with torch.device(dev):``.
"""

from __future__ import annotations

import torch

__all__ = [
    "where", "exp", "expm1", "minimum", "maximum", "stack", "concatenate",
    "ones_like", "zeros_like", "full_like", "zeros", "abs", "sign", "tanh",
    "sqrt", "logical_and", "logical_not", "isfinite",
]


def _as_tensor(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return torch.full_like(like, float(v))


def where(c, a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return torch.where(c, torch.full_like(c, float(a), dtype=torch.float32),
                           float(b))
    like = a if isinstance(a, torch.Tensor) else b
    return torch.where(c, _as_tensor(a, like), _as_tensor(b, like))


def minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=float(b))
    return torch.clamp(b, max=float(a))


def maximum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=float(b))
    return torch.clamp(b, min=float(a))


def stack(parts, axis=0):
    like = next(p for p in parts if isinstance(p, torch.Tensor))
    return torch.stack([_as_tensor(p, like) for p in parts], dim=axis)


def concatenate(parts, axis=0):
    return torch.cat(list(parts), dim=axis)


def zeros(shape, dtype=None):
    if not isinstance(dtype, torch.dtype):
        dtype = torch.get_default_dtype()
    return torch.zeros(tuple(shape), dtype=dtype)


def ones_like(x):
    return torch.ones_like(x)


def zeros_like(x):
    return torch.zeros_like(x)


def full_like(x, v):
    return torch.full_like(x, float(v))


def sqrt(x):
    """Correctly rounded (torch's float32 CPU sqrt is not in a few cases;
    the kernel's sqrtf and numpy's are)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


exp = torch.exp
expm1 = torch.expm1
abs = torch.abs  # noqa: A001 - mirrors the numpy namespace
sign = torch.sign
tanh = torch.tanh
logical_and = torch.logical_and
logical_not = torch.logical_not
isfinite = torch.isfinite
