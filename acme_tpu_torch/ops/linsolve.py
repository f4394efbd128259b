"""Small dense linear solves over a lane axis (``acme_tpu/ops/linsolve.py``).

The float64 scan engine's Newton systems are nn x nn with nn of a few
unknowns per subsystem; ``solve_dense`` is partial-pivot Gaussian
elimination written out over those few rows, batched over a leading lane
axis, in the JAX package's order of operations: the augmented (n, n+m)
matrix, the pivot as the first maximum of the column (``jnp.argmax``: the
first NaN, else the first of equal maxima), every row updated at every
step (rows at or above the pivot with a factor of 0, so that an inf or a
NaN spreads as in the JAX version), and back substitution with each dot
summed from its first term on.  The engine's kernel does the same per lane
(``csrc/dense.cuh``), so the two agree bit for bit.

A zero or non-finite pivot marks the lane's solve as failed (``ok``
False) instead of raising; the caller freezes that lane's Newton step
(``acme_tpu/ops/newton.py``).

This is not the fused kernel's ``linsolve_tiny.solve_rows`` (row and
column equilibration, iterative refinement).
"""

from __future__ import annotations

import torch

__all__ = ["solve_dense"]


def _first_max(col):
    """Per lane, the index of the first maximum of ``col`` (L, r), a NaN
    counting as the largest (the first NaN wins), and that value."""
    best = col[:, 0]
    idx = torch.zeros_like(best, dtype=torch.long)
    for i in range(1, col.shape[1]):
        v = col[:, i]
        take = ~torch.isnan(best) & ((v > best) | torch.isnan(v))
        best = torch.where(take, v, best)
        idx = torch.where(take, torch.full_like(idx, i), idx)
    return idx, best


def _dot_rows(a, x):
    """sum_j a[:, j] * x[:, j, :] summed from the first term on: a (L, r),
    x (L, r, m) -> (L, m)."""
    acc = a[:, 0, None] * x[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j, None] * x[:, j]
    return acc


def solve_dense(J, B):
    """Solve J X = B per lane: J (L, n, n), B (L, n, m), float32 or
    float64 on any device (a single system (n, n), (n, m) is taken as one
    lane).  Returns (X (L, n, m), ok (L,) bool); where ok is False (a zero
    or non-finite pivot) X is garbage that the caller must mask out."""
    single = J.dim() == 2
    if single:
        J, B = J[None], B[None]
    L, n, m = J.shape[0], J.shape[1], B.shape[2]
    dev, dt = J.device, J.dtype
    if n == 0:
        X, ok = torch.zeros((L, 0, m), dtype=dt, device=dev), \
            torch.ones((L,), dtype=torch.bool, device=dev)
    elif n == 1:
        piv = J[:, 0, 0]
        ok = (piv != 0) & torch.isfinite(piv)
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        X = B / safe[:, None, None]
    else:
        A = torch.cat([J, B], dim=2)
        ok = torch.ones((L,), dtype=torch.bool, device=dev)
        lanes = torch.arange(L, device=dev)
        for k in range(n):
            idx, piv_abs = _first_max(A[:, k:, k].abs())
            idx = idx + k
            ok = ok & (piv_abs > 0) & torch.isfinite(piv_abs)
            row_k = A[:, k].clone()
            row_p = A[lanes, idx]
            A[lanes, idx] = row_k
            A[:, k] = row_p
            piv = A[:, k, k]
            safe = torch.where(piv == 0, torch.ones_like(piv), piv)
            below = (torch.arange(n, device=dev) > k)[None, :]
            factors = torch.where(below, A[:, :, k] / safe[:, None],
                                  torch.zeros((), dtype=dt, device=dev))
            A = A - factors[:, :, None] * A[:, k, None, :]
        rows = [None] * n
        for i in range(n - 1, -1, -1):
            rhs = A[:, i, n:]
            if i + 1 < n:
                rhs = rhs - _dot_rows(A[:, i, i + 1:n],
                                      torch.stack(rows[i + 1:], dim=1))
            d = A[:, i, i]
            safe = torch.where(d == 0, torch.ones_like(d), d)
            rows[i] = rhs / safe[:, None]
        X = torch.stack(rows, dim=1)
    if single:
        return X[0], ok[0]
    return X, ok
