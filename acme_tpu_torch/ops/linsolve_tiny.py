"""Per-lane tiny dense solves, vectorised over lanes, in float32 or df.

A port of ``_solve_rows`` / ``_solve_raw`` of ``acme_tpu/ops/fused.py``:
the systems are lists of lists of per-lane tensors (one tiny system per
lane), solved with the same operations in the same order, so the CPU
results equal the JAX package's bit for bit.  ``xp=dfmath`` runs the
identical elimination on :class:`~acme_tpu_torch.ops.dfmath.DF` entries.
This is the plain version of the kernel's ``csrc/linsolve.cuh``.

n == 1, 2: closed form.  n >= 3: row/column inf-norm equilibration,
(per-lane pivoted) elimination and ``refine`` iterative-refinement sweeps.
"""

from __future__ import annotations

import torch

from . import dfmath

F32 = None  # selects plain float32 arithmetic (the JAX code's ``xp=jnp``)


def _recip_safe(v):
    return torch.where(v > 0, 1.0 / torch.where(v > 0, v, 1.0),
                       torch.ones_like(v))


def _where(c, a, b):
    return torch.where(c, a, b)


def solve_rows(J, R, refine=1, pivot=True, xp=F32):
    """Solve J X = R per lane; J is n x n (lists of tensors), R a list of m
    right-hand sides (each a list of n tensors).  Returns X as m lists."""
    n = len(J)
    m = len(R)
    if n == 1:
        inv = 1.0 / J[0][0]
        return [[R[j][0] * inv] for j in range(m)]
    if n == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = 1.0 / det
        return [[(R[j][0] * J[1][1] - R[j][1] * J[0][1]) * inv,
                 (R[j][1] * J[0][0] - R[j][0] * J[1][0]) * inv]
                for j in range(m)]

    df = xp is dfmath
    ab = (lambda v: torch.abs(v.hi + v.lo)) if df else torch.abs
    rs = []
    for i in range(n):
        mx = ab(J[i][0])
        for jj in range(1, n):
            mx = torch.maximum(mx, ab(J[i][jj]))
        rs.append(_recip_safe(mx))
    Jr = [[J[i][jj] * rs[i] for jj in range(n)] for i in range(n)]
    cs = []
    for jj in range(n):
        mx = ab(Jr[0][jj])
        for i in range(1, n):
            mx = torch.maximum(mx, ab(Jr[i][jj]))
        cs.append(_recip_safe(mx))
    Js = [[Jr[i][jj] * cs[jj] for jj in range(n)] for i in range(n)]
    Rs = [[R[j][i] * rs[i] for i in range(n)] for j in range(m)]
    Y = solve_raw(Js, Rs, pivot, xp=xp)
    X = [[Y[j][jj] * cs[jj] for jj in range(n)] for j in range(m)]
    for _ in range(refine):
        R2 = []
        for j in range(m):
            r2 = []
            for i in range(n):
                acc = R[j][i]
                for jj in range(n):
                    acc = acc - J[i][jj] * X[j][jj]
                r2.append(acc * rs[i])
            R2.append(r2)
        E = solve_raw(Js, R2, pivot, xp=xp)
        X = [[X[j][jj] + E[j][jj] * cs[jj] for jj in range(n)]
             for j in range(m)]
    return X


def solve_raw(J, R, pivot=True, xp=F32):
    """Elimination on per-lane rows; with ``pivot`` each step swaps in the
    max-|column| row per lane by selects (branch-free)."""
    n = len(J)
    m = len(R)
    df = xp is dfmath
    ab = (lambda v: torch.abs(v.hi + v.lo)) if df else torch.abs
    sel = dfmath.where if df else _where
    A = [J[i][:] + [R[j][i] for j in range(m)] for i in range(n)]
    w = n + m
    for k in range(n):
        if pivot:
            best = A[k]
            best_abs = ab(A[k][k])
            for i in range(k + 1, n):
                cand_abs = ab(A[i][k])
                take = cand_abs > best_abs
                new_best = [sel(take, A[i][c], best[c]) for c in range(w)]
                A[i] = [sel(take, best[c], A[i][c]) for c in range(w)]
                best = new_best
                best_abs = torch.maximum(cand_abs, best_abs)
            A[k] = best
        inv = 1.0 / A[k][k]
        for i in range(k + 1, n):
            fct = A[i][k] * inv
            tail = [A[i][c] - fct * A[k][c] for c in range(k, w)]
            zero = dfmath.zeros_like(fct) if df else torch.zeros_like(fct)
            A[i] = [zero] * k + tail
    X = [[None] * n for _ in range(m)]
    for i in range(n - 1, -1, -1):
        inv = 1.0 / A[i][i]
        for j in range(m):
            acc = A[i][n + j]
            for c in range(i + 1, n):
                acc = acc - A[i][c] * X[j][c]
            X[j][i] = acc * inv
    return X
