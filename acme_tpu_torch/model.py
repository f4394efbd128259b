"""DK-method model derivation: Circuit -> DiscreteModel.

The port's own copy of ``acme_tpu/model.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Build-time compiler mirroring ACME.jl/src/ACME.jl:118-464.  All of
the derivation runs in exact rational arithmetic (see .exact); the
result is a :class:`DiscreteModel` of dense float64 matrices

    x[n+1] = A x[n] + B u[n] + C z[n] + x0
    y[n]   = Dy x[n] + Ey u[n] + Fy z[n] + y0
    p_k[n] = Dq_k x[n] + Eq_k u[n] + Fqprev_k z[n]
    z_k[n] solves f_k(q0_k + Pexp_k p_k + Fq_k z_k) = 0

with per-subsystem nonlinear solvers.  The host runtime lives in
.runtime; the fused runner (ops.fused) compiles the same object further.
"""

from __future__ import annotations

import warnings
from fractions import Fraction
from itertools import combinations
from typing import List, Optional

import numpy as np

from .circuit import Circuit
from .exact import (consecranges, feye, frac, fzeros, gensolve, matsplit,
                    rank_factorize, to_float, blockdiag)
from .element import NLFunc
from .solvers import (HomotopySolver, ParametricNonLinEq, SimpleSolver,
                      default_solver)

__all__ = ["DiscreteModel", "model_matrices"]


def _argmax_abs_colmajor(a):
    best = None
    bi = bj = 0
    for j in range(a.shape[1]):
        for i in range(a.shape[0]):
            v = abs(a[i, j])
            if best is None or v > best:
                best = v
                bi, bj = i, j
    return bi, bj


def model_matrices(circ: Circuit, t: Fraction) -> dict:
    """Derive the global DK-method matrices exactly (ref ACME.jl:264-317).

    Uses the trapezoidal (bilinear) discretization: state rows enter as
    ``mxd/t + mx/2`` on the left and ``mxd/t - mx/2`` on the right.
    """
    t = frac(t)
    nb, nx, nq, nu = circ.nb, circ.nx, circ.nq, circ.nu
    mv, mi = circ.assemble("mv"), circ.assemble("mi")
    mx, mxd = circ.assemble("mx"), circ.assemble("mxd")
    mq, mu = circ.assemble("mq"), circ.assemble("mu")
    u0 = circ.u0()
    tv, ti = circ.topomat()

    half = Fraction(1, 2)
    lhs = np.vstack([
        np.hstack([mv, mi, mxd * (1 / t) + mx * half, mq]),
        np.hstack([blockdiag([tv, ti]), fzeros(nb, nx + nq)]),
    ])
    rhs = np.vstack([
        np.hstack([u0, mu, mxd * (1 / t) - mx * half]),
        fzeros(nb, 1 + nu + nx),
    ])
    x, f = gensolve(lhs, rhs)

    rowsizes = [nb, nb, nx, nq]
    rowranges = consecranges(rowsizes)
    fq = f[rowranges[3], :]

    nullspace = gensolve(fq, np.empty((fq.shape[0], 0), dtype=object))[1]
    indeterminates = np.dot(f, nullspace)

    if _sumabs2(indeterminates[rowranges[2], :]) > 1e-20:
        warnings.warn("State update depends on indeterminate quantity")

    while nullspace.shape[1] > 0:
        i, j = _argmax_abs_colmajor(nullspace)
        nullspace = np.delete(np.delete(nullspace, i, axis=0), j, axis=1)
        f = np.delete(f, i, axis=1)

    fblocks = matsplit(f, rowsizes)[0]
    mats = {"fv": fblocks[0], "fi": fblocks[1], "c": fblocks[2], "fq": fblocks[3]}

    xblocks = matsplit(x, rowsizes, [1, nu, nx])
    for names, blocks in zip(
            [("v0", "i0", "x0", "q0"), ("ev", "ei", "b", "eq_full"),
             ("dv", "di", "a", "dq_full")], xblocks):
        for name, blk in zip(names, blocks):
            mats[name] = blk
    for v in ("v0", "i0", "x0", "q0"):
        mats[v] = mats[v][:, 0]

    p = np.hstack([circ.assemble("pv"), circ.assemble("pi"),
                   circ.assemble("px") * half + circ.assemble("pxd") * (1 / t),
                   circ.assemble("pq")])
    if _sumabs2(np.dot(p, indeterminates)) > 1e-20:
        warnings.warn("Model output depends on indeterminate quantity")
    mats["dy"] = np.dot(p, x[:, 1 + nu:]) + circ.assemble("px") * half \
        - circ.assemble("pxd") * (1 / t)
    mats["ey"] = np.dot(p, x[:, 1:1 + nu])
    mats["fy"] = np.dot(p, f)
    mats["y0"] = np.dot(p, x[:, 0])
    return mats


def _sumabs2(a) -> float:
    s = Fraction(0)
    for v in np.asarray(a).reshape(-1):
        s += v * v
    return float(s)


def tryextract(fq, numcols) -> Optional[np.ndarray]:
    """Try to find a column transform making the leading ``numcols`` columns
    of ``fq`` the only ones its rows touch (ref ACME.jl:319-347).
    ``fq`` is consumed (pass a copy)."""
    n = fq.shape[1]
    a = feye(n)
    if numcols >= n:
        return a
    for colcnt in range(numcols):
        i, j = _argmax_abs_colmajor(fq[:, colcnt:])
        j += colcnt
        fq[:, [colcnt, j]] = fq[:, [j, colcnt]]
        a[:, [colcnt, j]] = a[:, [j, colcnt]]
        piv = fq[i, colcnt]
        factors = fq[i, colcnt + 1:] * (1 / piv)
        a[:, colcnt + 1:] = a[:, colcnt + 1:] - np.outer(a[:, colcnt], factors)
        fq[:, colcnt + 1:] = fq[:, colcnt + 1:] - np.outer(fq[:, colcnt], factors)
        fq = np.delete(fq, i, axis=0)
        if all(v == 0 for v in fq[:, colcnt + 1:].reshape(-1)):
            return a
    return None


def nldecompose(mats, nns, nqs) -> List[List[int]]:
    """Greedy search for an ordering of element subsets that makes the global
    Fq block lower-triangular, so the nonlinearity splits into a chain of
    smaller systems (ref ACME.jl:349-378).  Mutates mats[fq], mats[c],
    mats[fy]; returns the extracted element-index groups."""
    fq = mats["fq"]
    a = feye(fq.shape[1])
    sub_ranges = consecranges(nqs)
    extracted_subs: List[List[int]] = []
    rem_start = 0
    rem_nles = set(i for i, q in enumerate(nqs) if q > 0)

    while rem_nles:
        done = False
        for sz in range(1, len(rem_nles) + 1):
            for sub in combinations(sorted(rem_nles), sz):
                nn_sub = sum(nns[i] for i in sub)
                rows = [r for e in sub for r in range(sub_ranges[e].start, sub_ranges[e].stop)]
                a_update = tryextract(fq[np.ix_(rows, range(rem_start, fq.shape[1]))].copy(), nn_sub)
                if a_update is not None:
                    fq[:, rem_start:] = np.dot(fq[:, rem_start:], a_update)
                    a[:, rem_start:] = np.dot(a[:, rem_start:], a_update)
                    rem_start += nn_sub
                    extracted_subs.append(list(sub))
                    rem_nles.difference_update(sub)
                    done = True
                    break
            if done:
                break

    mats["c"] = np.dot(mats["c"], a)
    mats["fy"] = np.dot(mats["fy"], a)
    return extracted_subs


def split_nl_model_matrices(mats, model_qidxs, model_nns):
    """Split the global q/z blocks per subsystem (ref ACME.jl:381-401)."""
    nsub = len(model_qidxs)
    nn_total = sum(model_nns)
    colranges = consecranges(model_nns)
    dq_fulls, eq_fulls, fqs, fqprev_fulls, q0s = [], [], [], [], []
    for i, qidxs in enumerate(model_qidxs):
        sub_fq = mats["fq"][qidxs, :]
        fqs.append(sub_fq[:, colranges[i]])
        prev = fzeros(len(qidxs), nn_total)
        for jj in range(i):
            prev[:, colranges[jj]] = sub_fq[:, colranges[jj]]
        fqprev_fulls.append(prev)
        dq_fulls.append(mats["dq_full"][qidxs, :])
        eq_fulls.append(mats["eq_full"][qidxs, :])
        q0s.append(mats["q0"][qidxs])
    return {"dq_fulls": dq_fulls, "eq_fulls": eq_fulls, "fqs": fqs,
            "fqprev_fulls": fqprev_fulls, "q0s": q0s}


def reduce_pdims(mats):
    """Minimize each subsystem's solver-input dimension np
    (ref ACME.jl:403-451): rank-factorize [dq_full eq_full fqprev_full] =
    Pexp [dq eq fqprev], then project Pexp onto the orthogonal complement of
    col(Fq), folding the removed component into A, B, Dy, Ey and later
    subsystems' couplings."""
    subcount = len(mats["dq_fulls"])
    dqs = [None] * subcount
    eqs = [None] * subcount
    fqprevs = [None] * subcount
    pexps = [None] * subcount
    offset = 0
    for idx in range(subcount):
        combined = np.hstack([mats["dq_fulls"][idx], mats["eq_fulls"][idx],
                              mats["fqprev_fulls"][idx]])
        pexp, dqeq = rank_factorize(combined)
        pexps[idx] = pexp
        c1 = mats["dq_fulls"][idx].shape[1]
        c2 = mats["eq_fulls"][idx].shape[1]
        dqs[idx] = dqeq[:, :c1]
        eqs[idx] = dqeq[:, c1:c1 + c2]
        fqprevs[idx] = dqeq[:, c1 + c2:]

        fq = mats["fqs"][idx]
        nn = fq.shape[1]
        fq_pinv = gensolve(np.dot(fq.T, fq), fq.T.copy())[0]
        pexp_proj = pexp - np.dot(fq, np.dot(fq_pinv, pexp))
        pexp2, f2 = rank_factorize(pexp_proj)
        if pexp2.shape[1] < pexps[idx].shape[1]:
            cols = slice(offset, offset + nn)
            fold = np.dot(fq_pinv, pexps[idx])
            c_fold = np.dot(mats["c"][:, cols], fold)
            fy_fold = np.dot(mats["fy"][:, cols], fold)
            mats["a"] = mats["a"] - np.dot(c_fold, dqs[idx])
            mats["b"] = mats["b"] - np.dot(c_fold, eqs[idx])
            mats["dy"] = mats["dy"] - np.dot(fy_fold, dqs[idx])
            mats["ey"] = mats["ey"] - np.dot(fy_fold, eqs[idx])
            # the z change from the projection is -fold*(dq x + eq u +
            # fqprev z_prev); the x and u parts fold into A/B/Dy/Ey above
            # and the z_prev part into LATER subsystems' couplings below
            # -- but the z_prev part must ALSO fold into the direct C and
            # FY consumers of THIS subsystem's z, or every x-update and
            # output that reads it loses the earlier subsystems'
            # contribution.  The reference omits these two lines
            # (ACME.jl:427-431) and its own test never validates the
            # decomposed varying-pot output (runtests.jl:792-793 "TODO:
            # further validate y"); the omission silently killed ~99% of
            # the audio on the varying-pot superover chain (measured:
            # decomposed output 6e-3 vs 0.56 undecomposed; they agree
            # after the fix).  Fixed-pot decompositions were unaffected
            # because their reduced subsystems have no earlier-z
            # coupling (fqprev[:, :offset] = 0).
            mats["c"][:, :offset] = mats["c"][:, :offset] \
                - np.dot(c_fold, fqprevs[idx][:, :offset])
            mats["fy"][:, :offset] = mats["fy"][:, :offset] \
                - np.dot(fy_fold, fqprevs[idx][:, :offset])
            for idx2 in range(idx + 1, subcount):
                q = np.dot(np.dot(mats["fqprev_fulls"][idx2][:, cols], fq_pinv), pexps[idx])
                mats["dq_fulls"][idx2] = mats["dq_fulls"][idx2] - np.dot(q, dqs[idx])
                mats["eq_fulls"][idx2] = mats["eq_fulls"][idx2] - np.dot(q, eqs[idx])
                mats["fqprev_fulls"][idx2][:, :offset] = \
                    mats["fqprev_fulls"][idx2][:, :offset] - np.dot(q, fqprevs[idx][:, :offset])
            pexps[idx] = pexp2
            dqs[idx] = np.dot(f2, dqs[idx])
            eqs[idx] = np.dot(f2, eqs[idx])
            fqprevs[idx] = np.dot(f2, fqprevs[idx])
            mats["dq_fulls"][idx] = np.dot(pexp2, dqs[idx])
            mats["eq_fulls"][idx] = np.dot(pexp2, eqs[idx])
            mats["fqprev_fulls"][idx] = np.dot(pexp2, fqprevs[idx])
        offset += nn
    mats.update(dqs=dqs, eqs=eqs, fqprevs=fqprevs, pexps=pexps)
    return mats


def _make_sub_func(nl: NLFunc, fq: np.ndarray):
    """Subsystem residual: q = pfull + Fq z; res, Jq = nl(q); J = Jq Fq
    (ref ACME.jl:176-189)."""
    def func(res, J, scratch, z):
        pfull, Jq_buf = scratch[0], scratch[1]
        q = pfull + fq @ z
        r, Jq = nl(np, q)
        res[:] = r
        Jq_buf[:] = Jq
        J[:] = Jq @ fq
    return func


def initial_solution(sub_func, q0, nn):
    """Homotopy from q=0 to q0 for the first operating point
    (ref ACME.jl:453-464)."""
    nq = len(q0)
    nleq = ParametricNonLinEq(sub_func, nn=nn, np_=nq)
    solver = HomotopySolver(nleq, np.zeros(nq), np.zeros(nn), base=SimpleSolver)
    z = solver.solve(np.asarray(q0, float))
    if not solver.hasconverged():
        raise RuntimeError("Failed to find initial solution")
    return np.array(z, float)


class DiscreteModel:
    """A compiled circuit model (float64) plus per-subsystem host solvers.

    ``DiscreteModel(circ, t)`` derives the model for sample interval ``t``
    (pass ``Fraction(1, fs)`` for exactness; floats are converted exactly).
    ``solver`` is a factory ``(nleq, p0, z0) -> solver``; the default is the
    reference's HomotopySolver{CachingSolver{SimpleSolver}} chain.
    ``matrices`` takes a precomputed ``model_matrices(circ, t)`` (the exact
    part, nearly all of a build's time; it pickles, so a worker process
    can compute it).
    """

    def __init__(self, circ: Optional[Circuit] = None, t=None, *,
                 solver=default_solver, decompose_nonlinearity=True,
                 matrices=None, _mats=None, _nl_funcs=None, _solvers=None):
        if circ is None:
            # internal path: build directly from float matrices (linearize)
            self._init_from_float_mats(_mats, _nl_funcs or [], _solvers or [])
            return

        mats = model_matrices(circ, t) if matrices is None else matrices
        elems = list(circ.elements.values())
        nns = [e.nn for e in elems]
        nqs = [e.nq for e in elems]
        if decompose_nonlinearity:
            nl_elems = nldecompose(mats, nns, nqs)
        else:
            group = [i for i, n in enumerate(nns) if n > 0]
            nl_elems = [group] if group else []

        model_nns = [sum(nns[i] for i in g) for g in nl_elems]
        qranges = consecranges(nqs)
        model_qidxs = [[r for i in g for r in range(qranges[i].start, qranges[i].stop)]
                       for g in nl_elems]
        mats.update(split_nl_model_matrices(mats, model_qidxs, model_nns))
        mats = reduce_pdims(mats)

        assert circ.nn == sum(model_nns)

        # float views for the nonlinear build steps
        def F(m):
            return to_float(m)

        sub_nls = [circ.nonlinear_eq_func(g) for g in nl_elems]
        sub_funcs = [_make_sub_func(nl, F(fq))
                     for nl, fq in zip(sub_nls, mats["fqs"])]

        init_zs = [np.zeros(nn) for nn in model_nns]
        for idx in range(len(sub_funcs)):
            q = F(mats["q0s"][idx]) + F(mats["fqprev_fulls"][idx]) @ _vcat(init_zs)
            init_zs[idx] = initial_solution(sub_funcs[idx], q, model_nns[idx])

        # eliminate subsystems with constant (0-dimensional) p
        # (ref ACME.jl:202-228)
        while True:
            const_idxs = [i for i, dq in enumerate(mats["dqs"]) if dq.shape[0] == 0]
            if not const_idxs:
                break
            nnranges = consecranges(model_nns)
            const_z = [z for i in const_idxs for z in range(nnranges[i].start, nnranges[i].stop)]
            varying_z = [z for z in range(sum(model_nns)) if z not in const_z]
            const_zvec = _vcat([init_zs[i] for i in const_idxs])
            for idx in range(len(mats["q0s"])):
                mats["q0s"][idx] = mats["q0s"][idx] + \
                    np.dot(mats["fqprev_fulls"][idx][:, const_z], _fracvec(const_zvec))
                mats["fqprev_fulls"][idx] = mats["fqprev_fulls"][idx][:, varying_z]
            mats["x0"] = mats["x0"] + np.dot(mats["c"][:, const_z], _fracvec(const_zvec))
            mats["y0"] = mats["y0"] + np.dot(mats["fy"][:, const_z], _fracvec(const_zvec))
            for key in ("q0s", "dq_fulls", "eq_fulls", "fqs", "fqprev_fulls"):
                mats[key] = [m for i, m in enumerate(mats[key]) if i not in const_idxs]
            init_zs = [z for i, z in enumerate(init_zs) if i not in const_idxs]
            model_nns = [n for i, n in enumerate(model_nns) if i not in const_idxs]
            sub_nls = [f for i, f in enumerate(sub_nls) if i not in const_idxs]
            sub_funcs = [f for i, f in enumerate(sub_funcs) if i not in const_idxs]
            nl_elems = [g for i, g in enumerate(nl_elems) if i not in const_idxs]
            mats["fy"] = mats["fy"][:, varying_z]
            mats["c"] = mats["c"][:, varying_z]
            mats = reduce_pdims(mats)
            # rebuild float sub funcs against the updated fqs
            sub_funcs = [_make_sub_func(nl, F(fq))
                         for nl, fq in zip(sub_nls, mats["fqs"])]

        # freeze floats
        self.a, self.b, self.c = F(mats["a"]), F(mats["b"]), F(mats["c"])
        self.x0 = F(mats["x0"])
        self.dy, self.ey, self.fy = F(mats["dy"]), F(mats["ey"]), F(mats["fy"])
        self.y0 = F(mats["y0"])
        self.pexps = [F(m) for m in mats["pexps"]]
        self.dqs = [F(m) for m in mats["dqs"]]
        self.eqs = [F(m) for m in mats["eqs"]]
        self.fqprevs = [F(m) for m in mats["fqprevs"]]
        self.fqs = [F(m) for m in mats["fqs"]]
        self.q0s = [F(m) for m in mats["q0s"]]
        self.init_zs = init_zs
        self.nl_funcs = sub_nls
        self.nl_elems = nl_elems
        self.x = np.zeros(len(self.x0))

        # per-subsystem parametric equations + solvers (ref ACME.jl:236-260)
        self.nleqs = []
        self.solvers = []
        for idx in range(len(self.q0s)):
            nleq = self._make_nleq(idx, sub_funcs[idx])
            s = solver(nleq, np.zeros(self.np(idx)), init_zs[idx])
            self.nleqs.append(nleq)
            self.solvers.append(s)

    def _make_nleq(self, idx, sub_func):
        pexp, q0 = self.pexps[idx], self.q0s[idx]
        nn, nq_, np_ = self.nn(idx), len(q0), self.np(idx)

        def set_p(scratch, p):
            scratch[0][:] = q0 + pexp @ p

        def calc_Jp(scratch, Jp):
            Jp[:] = scratch[1] @ pexp

        scratch = (np.zeros(nq_), np.zeros((nn, nq_)))
        return ParametricNonLinEq(sub_func, set_p, calc_Jp, scratch, nn, np_)

    def _init_from_float_mats(self, mats, nl_funcs, solvers):
        self.a, self.b, self.c = mats["a"], mats["b"], mats["c"]
        self.x0 = mats["x0"]
        self.dy, self.ey, self.fy = mats["dy"], mats["ey"], mats["fy"]
        self.y0 = mats["y0"]
        self.pexps = mats.get("pexps", [])
        self.dqs = mats.get("dqs", [])
        self.eqs = mats.get("eqs", [])
        self.fqprevs = mats.get("fqprevs", [])
        self.fqs = mats.get("fqs", [])
        self.q0s = mats.get("q0s", [])
        self.init_zs = mats.get("init_zs", [])
        self.nl_funcs = nl_funcs
        self.nl_elems = []
        self.nleqs = []
        self.solvers = solvers
        self.x = np.zeros(len(self.x0))

    # dimensions (ref ACME.jl:466-472)
    @property
    def nx(self):
        return len(self.x0)

    @property
    def nu(self):
        return self.b.shape[1]

    @property
    def ny(self):
        return len(self.y0)

    def nq(self, idx):
        return len(self.q0s[idx])

    def np(self, idx):
        return self.dqs[idx].shape[0]

    def nn(self, idx=None):
        if idx is None:
            return sum(fq.shape[1] for fq in self.fqs)
        return self.fqs[idx].shape[1]

    @property
    def nsubsystems(self):
        return len(self.q0s)

    # runtime entry points are provided by .runtime and exported by the
    # package __init__ (run, steadystate, linearize).


def _vcat(vs):
    return np.concatenate([np.asarray(v, float) for v in vs]) if vs else np.zeros(0)


def _fracvec(v):
    out = np.empty(len(v), dtype=object)
    for i, x in enumerate(v):
        out[i] = frac(float(x))
    return out
