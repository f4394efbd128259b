"""Exact rational linear algebra for build-time model derivation.

The port's own copy of ``acme_tpu/exact.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

The DK-method state-space derivation must be carried out in exact arithmetic
so that structural zeros stay zeros (the nonlinearity decomposition and the
rank factorizations depend on it).  The reference implementation
(ACME.jl/src/ACME.jl:717-777 and ACME.jl/src/circuit.jl:208-252)
uses Julia ``Rational{BigInt}`` sparse matrices; here we use
``fractions.Fraction`` scalars held in numpy ``object`` arrays.  Matrix sizes
at build time are tiny (tens to low hundreds), so dense object arrays are
simpler and fast enough; rounding to the runtime dtype happens exactly once,
when the model is frozen.

This module is cold-path (runs once per circuit at model-build time); nothing
in here touches JAX or the TPU.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = [
    "frac", "fzeros", "feye", "fmat", "fvec", "to_float",
    "gensolve", "rank_factorize", "topomat",
    "consecranges", "matsplit", "blockdiag", "nnz",
]

_ZERO = Fraction(0)
_ONE = Fraction(1)


def frac(x) -> Fraction:
    """Convert a number to an exact Fraction.

    Floats convert via their exact binary expansion, mirroring Julia's
    ``Rational{BigInt}(::Float64)`` used throughout the reference build
    pipeline (ACME.jl/src/ACME.jl:264-317).
    """
    if isinstance(x, Fraction):
        return x
    if isinstance(x, (int, np.integer)):
        return Fraction(int(x))
    if isinstance(x, (float, np.floating)):
        return Fraction(float(x))
    raise TypeError(f"cannot convert {type(x)!r} to Fraction")


def fzeros(m: int, n: int) -> np.ndarray:
    a = np.empty((m, n), dtype=object)
    a[...] = _ZERO
    return a


def feye(n: int) -> np.ndarray:
    a = fzeros(n, n)
    for i in range(n):
        a[i, i] = _ONE
    return a


def fmat(x) -> np.ndarray:
    """Convert scalar / nested list / ndarray to a 2-D object array of Fractions."""
    a = np.asarray(x)
    if a.ndim == 0:
        a = a.reshape(1, 1)
    elif a.ndim == 1:
        a = a.reshape(-1, 1)
    elif a.ndim != 2:
        raise ValueError("fmat expects at most 2-D input")
    out = np.empty(a.shape, dtype=object)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            out[i, j] = frac(a[i, j])
    return out


def fvec(x) -> np.ndarray:
    a = np.asarray(x)
    out = np.empty(a.size, dtype=object)
    flat = a.reshape(-1)
    for i in range(a.size):
        out[i] = frac(flat[i])
    return out


def to_float(a: np.ndarray, dtype=np.float64) -> np.ndarray:
    return np.asarray(a, dtype=dtype)


def nnz(a: np.ndarray) -> int:
    return int(sum(1 for v in a.reshape(-1) if v != 0))


def consecranges(lengths):
    """Consecutive slices covering ``sum(lengths)`` (ref ACME.jl:771)."""
    out = []
    off = 0
    for ln in lengths:
        out.append(slice(off, off + ln))
        off += ln
    return out


def matsplit(m: np.ndarray, rowsizes, colsizes=None):
    """Split matrix into blocks; returns nested list [colgroup][rowgroup].

    Mirrors the column-major flattening of the reference ``matsplit``
    (ACME.jl/src/ACME.jl:773-777): iterating the returned structure
    yields, for each column group, all row groups in order.
    """
    if colsizes is None:
        colsizes = [m.shape[1]]
    rr = consecranges(rowsizes)
    cc = consecranges(colsizes)
    return [[m[r, c] for r in rr] for c in cc]


def blockdiag(mats) -> np.ndarray:
    mats = list(mats)
    M = sum(a.shape[0] for a in mats)
    N = sum(a.shape[1] for a in mats)
    out = fzeros(M, N)
    i = j = 0
    for a in mats:
        out[i:i + a.shape[0], j:j + a.shape[1]] = a
        i += a.shape[0]
        j += a.shape[1]
    return out


def _row_nnz(a: np.ndarray) -> list:
    return [sum(1 for v in row if v != 0) for row in a]


def _col_nnz(a: np.ndarray, j: int) -> int:
    return sum(1 for v in a[:, j] if v != 0)


def gensolve(a: np.ndarray, b: np.ndarray, thresh: Fraction = Fraction(1, 10)):
    """Generalized sparse solver over exact rationals.

    For ``a @ x = b`` returns ``(x, h)`` where ``x`` is a particular solution
    and the columns of ``h`` span the nullspace of ``a`` (so the full solution
    set is ``x + h @ y`` for arbitrary ``y``).  Pivot choice follows the
    reference (ACME.jl/src/ACME.jl:717-747): rows are processed in
    ascending order of their nonzero count (stable); within a row, among
    candidate columns whose pivot magnitude is at least ``thresh`` times the
    maximum, the column of ``h`` with the fewest nonzeros is chosen.
    """
    m, n = a.shape
    k = b.shape[1]
    x = fzeros(n, k)
    h = feye(n)
    if m == 0:
        return x, h
    order = np.argsort(_row_nnz(a), kind="stable")
    for i in order:
        ait = a[i, :]
        if h.shape[1] == 0:
            continue
        s = np.dot(ait, h)  # row of projections onto current nullspace basis
        nz = [j for j in range(len(s)) if s[j] != 0]
        if not nz:
            continue
        max_abs = max(abs(s[j]) for j in nz)
        cand = [j for j in nz if abs(s[j]) >= thresh * max_abs]
        j = min(cand, key=lambda jj: _col_nnz(h, jj))
        q = h[:, j].copy()
        sj = s[j]  # == ait @ q
        resid = b[i, :] - np.dot(ait, x)
        x = x + np.outer(q, resid) * (1 / sj)
        if h.shape[1] > 1:
            keep = [jj for jj in range(h.shape[1]) if jj != j]
            h = h[:, keep] - np.outer(q, s[keep]) * (1 / sj)
        else:
            h = np.empty((n, 0), dtype=object)
    return x, h


def rank_factorize(a: np.ndarray):
    """Factor ``a = c @ f`` with minimal inner dimension (exact rank).

    Mirrors ACME.jl/src/ACME.jl:749-762: computes a basis of the left
    nullspace of ``a`` via :func:`gensolve`, then peels off dependent rows.
    """
    f = a.copy()
    m = a.shape[0]
    nullspace = gensolve(a.T.copy(), np.empty((a.shape[1], 0), dtype=object))[1]
    c = feye(m)
    while nullspace.shape[1] > 0:
        i, j = _argmax_abs(nullspace)
        piv = nullspace[i, j]
        c = c - np.outer(c[:, i], nullspace[:, j]) * (1 / piv)
        c = np.delete(c, i, axis=1)
        nullspace = nullspace - np.outer(nullspace[:, j], nullspace[i, :]) * (1 / piv)
        nullspace = np.delete(np.delete(nullspace, i, axis=0), j, axis=1)
        f = np.delete(f, i, axis=0)
    return c, f


def _argmax_abs(a: np.ndarray):
    """Index of the max-|.| entry, column-major first occurrence (Julia argmax order)."""
    best = None
    bi = bj = 0
    for j in range(a.shape[1]):
        for i in range(a.shape[0]):
            v = abs(a[i, j])
            if best is None or v > best:
                best = v
                bi, bj = i, j
    return bi, bj


def topomat(incidence: np.ndarray):
    """Tree/cotree reduction of an incidence matrix by integer elimination.

    Given the (nodes x branches) incidence matrix, returns ``(tv, ti)`` such
    that Kirchhoff's laws read ``tv @ v == 0`` and ``ti @ i == 0``.
    Mirrors ACME.jl/src/circuit.jl:208-249.
    """
    incid = np.array(incidence, dtype=object, copy=True)
    nnodes, nb = incid.shape
    for v in incid.reshape(-1):
        if v != 0 and abs(v) != 1:
            raise AssertionError("incidence matrix entries must be in {-1,0,1}")
    for j in range(nb):
        if sum(incid[:, j]) != 0:
            raise AssertionError("incidence matrix columns must sum to zero")

    t = np.zeros(nb, dtype=bool)
    row = 0
    for col in range(nb):
        rows = [r for r in range(nnodes) if r >= row and incid[r, col] != 0]
        assert len(rows) <= 2
        if not rows:
            continue
        t[col] = True
        if rows[0] != row:
            incid[[rows[0], row], :] = incid[[row, rows[0]], :]
        if len(rows) == 2:
            assert incid[row, col] + incid[rows[1], col] == 0
            incid[rows[1], :] = incid[rows[1], :] + incid[row, :]
        if incid[row, col] < 0:
            incid[row, :] = -incid[row, :]
        for r in range(row):
            if incid[r, col] == 1:
                incid[r, :] = incid[r, :] - incid[row, :]
            elif incid[r, col] == -1:
                incid[r, :] = incid[r, :] + incid[row, :]
        row += 1

    ti = incid[:row, :]
    tcols = [j for j in range(nb) if t[j]]
    lcols = [j for j in range(nb) if not t[j]]
    dl = ti[:, lcols]
    tv = fzeros(dl.shape[1], nb)
    for a, j in enumerate(tcols):
        for b_ in range(dl.shape[1]):
            tv[b_, j] = -dl[a, b_] if dl[a, b_] != 0 else _ZERO
    for a, j in enumerate(lcols):
        tv[a, j] = _ONE
    # normalize ti entries to Fractions as well
    ti = np.array([[frac(v) for v in r] for r in ti], dtype=object).reshape(row, nb) \
        if row > 0 else np.empty((0, nb), dtype=object)
    return tv, ti
