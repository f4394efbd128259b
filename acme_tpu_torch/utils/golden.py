"""50-digit reference runs: an independent per-sample simulator in mpmath.

The port's own copy of ``acme_tpu/utils/golden.py``: the same names and the
same arithmetic, numpy and mpmath only (mpmath imported inside the
functions); it imports nothing of ``acme_tpu``.

The port's parity chain is fused kernel -> scan engine -> host runtime,
all written by the same authors.  This module breaks the self-reference:
it re-implements the run loop (ACME.jl/src/ACME.jl:666-715) from the
equations alone -- arbitrary-precision mpmath arithmetic, plain undamped
Newton, textbook Gaussian elimination -- sharing NOTHING with the
production runtimes except the frozen model matrices and the element
residual definitions (which are the physics spec itself, evaluated here
through an mpmath array namespace rather than numpy or torch).

Accuracy: with dps=50 every rounding source is >=40 digits below the
signal, so a disagreement beyond f64 roundoff with the host runtime is a
bug in the runtime, not in the oracle.

Used by tests/test_torch_golden.py and ``chip_smoke.py`` against the
committed traces (tests/golden/*.npz, written by tests/golden/generate.py,
and the main path's tests/golden_torch/*.npz, written by
tests/golden_torch/generate.py with this module).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MPX", "golden_run", "golden_steadystate", "trace_db",
           "host_start", "engine_start", "fused_start", "fused_point"]


class MPX:
    """Minimal mpmath-backed array namespace for the element
    nonlinearities (the ``xp`` protocol of the port's ``elements``): object
    ndarrays of ``mpmath.mpf`` with the handful of ops the physics uses.

    Comparisons/selects (`where`, `logical_*`, `sign`) return plain
    numpy bool/object arrays; arithmetic stays exact-precision mpf.
    """

    def __init__(self, mp):
        self.mp = mp

    # -- construction -----------------------------------------------------
    def _lift(self, x):
        a = np.asarray(x, dtype=object)
        flat = a.reshape(-1)
        out = np.empty(flat.shape, dtype=object)
        for i, v in enumerate(flat):
            out[i] = v if isinstance(v, self.mp.mpf) else self.mp.mpf(repr(
                float(v)) if isinstance(v, float) else v)
        return out.reshape(a.shape)

    def stack(self, seq):
        return np.stack([np.asarray(s, dtype=object) for s in seq])

    def concatenate(self, seq, axis=0):
        return np.concatenate([np.asarray(s, dtype=object) for s in seq],
                              axis=axis)

    def zeros(self, shape, dtype=None):
        # dtype accepted for xp-protocol compatibility; always object/mpf
        a = np.empty(shape, dtype=object)
        a[...] = self.mp.mpf(0)
        return a

    def zeros_like(self, x):
        return self.zeros(np.shape(x))

    def ones_like(self, x):
        a = np.empty(np.shape(x), dtype=object)
        a[...] = self.mp.mpf(1)
        return a

    def full_like(self, x, v):
        a = np.empty(np.shape(x), dtype=object)
        a[...] = self.mp.mpf(repr(float(v)))
        return a

    # -- elementwise math --------------------------------------------------
    def _map(self, f, x):
        a = np.asarray(x, dtype=object)
        out = np.empty(a.shape, dtype=object)
        for idx in np.ndindex(a.shape):
            out[idx] = f(a[idx])
        return out

    def exp(self, x):
        return self._map(self.mp.exp, x)

    def tanh(self, x):
        return self._map(self.mp.tanh, x)

    def sqrt(self, x):
        return self._map(self.mp.sqrt, x)

    def abs(self, x):
        return self._map(abs, x)

    def sign(self, x):
        return self._map(self.mp.sign, x)

    def minimum(self, a, b):
        a_ = np.asarray(a, dtype=object) if np.ndim(a) else a
        b_ = np.asarray(b, dtype=object) if np.ndim(b) else b
        ba, bb = np.broadcast_arrays(np.asarray(a_, dtype=object),
                                     np.asarray(b_, dtype=object))
        out = np.empty(ba.shape, dtype=object)
        for idx in np.ndindex(ba.shape):
            out[idx] = ba[idx] if ba[idx] < bb[idx] else bb[idx]
        return out

    def maximum(self, a, b):
        ba, bb = np.broadcast_arrays(np.asarray(a, dtype=object),
                                     np.asarray(b, dtype=object))
        out = np.empty(ba.shape, dtype=object)
        for idx in np.ndindex(ba.shape):
            out[idx] = ba[idx] if ba[idx] > bb[idx] else bb[idx]
        return out

    # -- predicates / selection --------------------------------------------
    def logical_and(self, a, b):
        return np.logical_and(np.asarray(a, bool), np.asarray(b, bool))

    def logical_not(self, a):
        return np.logical_not(np.asarray(a, bool))

    def where(self, cond, a, b):
        cond_b, ba, bb = np.broadcast_arrays(
            np.asarray(cond), np.asarray(a, dtype=object),
            np.asarray(b, dtype=object))
        out = np.empty(cond_b.shape, dtype=object)
        for idx in np.ndindex(cond_b.shape):
            out[idx] = ba[idx] if cond_b[idx] else bb[idx]
        return out


def _mp_solve(mp, A, rhs):
    """Textbook partial-pivot Gaussian elimination on object matrices."""
    n = A.shape[0]
    M = np.concatenate([A.copy(), rhs.reshape(n, 1)], axis=1)
    for k in range(n):
        piv = k + int(np.argmax([abs(M[i, k]) for i in range(k, n)]))
        if piv != k:
            M[[k, piv]] = M[[piv, k]]
        if M[k, k] == 0:
            raise ZeroDivisionError("singular Jacobian in golden Newton")
        for i in range(k + 1, n):
            f = M[i, k] / M[k, k]
            M[i, k:] = M[i, k:] - f * M[k, k:]
    x = np.empty(n, dtype=object)
    for i in range(n - 1, -1, -1):
        acc = M[i, n]
        for j in range(i + 1, n):
            acc = acc - M[i, j] * x[j]
        x[i] = acc / M[i, i]
    return x


def golden_steadystate(model, u_const=None, dps: int = 50,
                       newton_tol: float = 1e-35, max_iter: int = 2000):
    """Independent steady state in mpmath: solve the coupled fixed point

        x = A x + B u + C z + x0,   f_k(q_k(x, u, z)) = 0  for all k

    by Newton on the full z vector with x eliminated through
    (I - A)^{-1} -- the reference's steadystate structure
    (ACME.jl/src/ACME.jl:474-497) re-derived from the equations.
    Returns (x, z) as float64 arrays (for seeding both the golden and the
    production runs from the identical representable point).
    """
    import mpmath
    nx, nsub = model.nx, model.nsubsystems
    nn_tot = model.nn()
    u_const = np.zeros(model.nu) if u_const is None else \
        np.asarray(u_const, float)
    with mpmath.workdps(dps):
        mp = mpmath
        mpx = MPX(mp)
        lift = mpx._lift
        a = lift(np.asarray(model.a, float))
        b = lift(np.asarray(model.b, float))
        c = lift(np.asarray(model.c, float))
        x0 = lift(np.asarray(model.x0, float))
        ut = lift(u_const)
        # x = (I-A)^{-1} (B u + C z + x0) = xc + Xz z
        ia = mpx.zeros((nx, nx))
        for i in range(nx):
            ia[i, i] = mp.mpf(1)
        ia = ia - a
        rhs_c = b @ ut + x0
        xc = (_mp_solve(mp, ia, rhs_c) if nx else mpx.zeros(0))
        Xz = np.stack([_mp_solve(mp, ia, c[:, j]) for j in range(nn_tot)],
                      axis=1) if nx and nn_tot else mpx.zeros((nx, nn_tot))
        offs = np.cumsum([0] + [model.nn(k) for k in range(nsub)])
        # q_k(z) = qc_k + Mq_k z (affine)
        qcs, Mqs = [], []
        for k in range(nsub):
            dq = lift(np.asarray(model.dqs[k], float))
            eq = lift(np.asarray(model.eqs[k], float))
            fqprev = lift(np.asarray(model.fqprevs[k], float))
            fq = lift(np.asarray(model.fqs[k], float))
            pexp = lift(np.asarray(model.pexps[k], float))
            q0 = lift(np.asarray(model.q0s[k], float))
            qc = q0 + pexp @ (dq @ xc + eq @ ut)
            Mq = pexp @ (dq @ Xz + fqprev)
            Mq[:, offs[k]:offs[k + 1]] = Mq[:, offs[k]:offs[k + 1]] + fq
            qcs.append(qc)
            Mqs.append(Mq)
        z = (np.concatenate([lift(np.asarray(zk, float))
                             for zk in model.init_zs])
             if nn_tot else mpx.zeros(0))
        tol = mp.mpf(repr(newton_tol))
        for it in range(max_iter):
            res = mpx.zeros(nn_tot)
            J = mpx.zeros((nn_tot, nn_tot))
            for k in range(nsub):
                q = qcs[k] + Mqs[k] @ z
                r_k, Jq = model.nl_funcs[k](mpx, q)
                res[offs[k]:offs[k + 1]] = r_k
                J[offs[k]:offs[k + 1], :] = Jq @ Mqs[k]
            rmax = max(abs(v) for v in res) if nn_tot else mp.mpf(0)
            if rmax < tol:
                break
            dz = _mp_solve(mp, J, res)
            mag = max(abs(v) for v in dz)
            if mag > 1:
                dz = dz / mag
            z = z - dz
        else:
            raise RuntimeError(
                f"golden steady-state Newton did not converge "
                f"(residual {float(rmax):.3e})")
        x = xc + Xz @ z if nx else mpx.zeros(0)
        return (np.array([float(v) for v in x]),
                np.array([float(v) for v in z]))


def golden_run(model, u, dps: int = 50, newton_tol: float = 1e-35,
               max_iter: int = 400, x_init=None, z_init=None):
    """Run ``model`` on input ``u`` ((nu, T) float) entirely in mpmath.

    Reproduces the reference per-sample loop (ACME.jl:666-715): ordered
    subsystem Newton solves warm-started from the previous sample, then
    the output row and state update.  Everything -- matrices, state,
    Newton -- is ``dps``-digit mpmath; the only float64 anywhere is the
    input and the returned output.

    ``x_init``/``z_init``: optional float64 starting state (e.g. from
    :func:`golden_steadystate`) -- saved alongside the trace so the
    production run under test starts from the IDENTICAL representable
    point.

    Returns y (ny, T) float64.
    """
    import mpmath
    u = np.asarray(u, float)
    with mpmath.workdps(dps):
        mp = mpmath
        mpx = MPX(mp)
        lift = mpx._lift

        a = lift(np.asarray(model.a, float))
        b = lift(np.asarray(model.b, float))
        c = lift(np.asarray(model.c, float))
        x0 = lift(np.asarray(model.x0, float))
        dy = lift(np.asarray(model.dy, float))
        ey = lift(np.asarray(model.ey, float))
        fy = lift(np.asarray(model.fy, float))
        y0 = lift(np.asarray(model.y0, float))
        nsub = model.nsubsystems
        dqs = [lift(np.asarray(model.dqs[k], float)) for k in range(nsub)]
        eqs = [lift(np.asarray(model.eqs[k], float)) for k in range(nsub)]
        fqprevs = [lift(np.asarray(model.fqprevs[k], float))
                   for k in range(nsub)]
        fqs = [lift(np.asarray(model.fqs[k], float)) for k in range(nsub)]
        pexps = [lift(np.asarray(model.pexps[k], float))
                 for k in range(nsub)]
        q0s = [lift(np.asarray(model.q0s[k], float)) for k in range(nsub)]

        nx, ny = model.nx, model.ny
        T = u.shape[1]
        x = (lift(np.asarray(x_init, float)) if x_init is not None
             else mpx.zeros(nx))
        z = (lift(np.asarray(z_init, float)) if z_init is not None
             else np.concatenate([lift(np.asarray(zk, float))
                                  for zk in model.init_zs])
             if model.nn() else mpx.zeros(0))
        offs = np.cumsum([0] + [model.nn(k) for k in range(nsub)])
        tol = mp.mpf(repr(newton_tol))

        y_out = np.zeros((ny, T))
        for t in range(T):
            ut = lift(u[:, t])
            for k in range(nsub):
                nn_k = model.nn(k)
                if nn_k == 0:
                    continue
                p = dqs[k] @ x + eqs[k] @ ut + fqprevs[k] @ z
                pfull = q0s[k] + pexps[k] @ p
                zk = z[offs[k]:offs[k + 1]].copy()
                for _ in range(max_iter):
                    q = pfull + fqs[k] @ zk
                    res, Jq = model.nl_funcs[k](mpx, q)
                    rmax = max(abs(v) for v in res)
                    if rmax < tol:
                        break
                    J = Jq @ fqs[k]
                    dz = _mp_solve(mp, J, res)
                    # bounded steps, like every production solver here: an
                    # Newton overshoot on exp() nonlinearities otherwise
                    # explodes before it can walk back
                    mag = max(abs(v) for v in dz)
                    if mag > 1:
                        dz = dz / mag
                    zk = zk - dz
                else:
                    raise RuntimeError(
                        f"golden Newton did not converge at sample {t}, "
                        f"subsystem {k} (residual {float(rmax):.3e})")
                z[offs[k]:offs[k + 1]] = zk
            yv = dy @ x + ey @ ut + fy @ z + y0
            for oi in range(ny):
                y_out[oi, t] = float(yv[oi])
            x = a @ x + b @ ut + c @ z + x0
        return y_out


# -- the port's runtimes at a trace's start ----------------------------------
#
# A trace (an npz of tests/golden or tests/golden_torch) holds the input u
# (nu, T) and the 50-digit output y (ny, T); a steady-seeded or resumed trace
# also its start state in the model's coordinates, x_init (nx,) and z_init
# (nn,) in float64, and one resumed from the scan engine's carry that
# carry's warm starts, p_init (sum of np) and dzdp_init (sum of nn * np).

def trace_db(y, y_gold):
    """A run's error against a trace: its largest deviation over the
    trace's peak (at least 1e-9), in dB (tests/test_golden.py's score)."""
    y, y_gold = np.asarray(y, float), np.asarray(y_gold, float)
    ref = max(float(np.max(np.abs(y_gold))), 1e-9)
    return float(20 * np.log10(float(np.max(np.abs(y - y_gold))) / ref
                               + 1e-300))


def _warm_parts(model, trace):
    """(p, z, dz/dp) of each subsystem at a trace's start: the trace's own
    p_init and dzdp_init where it saved them, else None for p and dz/dp."""
    z = np.asarray(trace["z_init"], float)
    p_all = np.asarray(trace["p_init"], float) if "p_init" in trace else None
    d_all = np.asarray(trace["dzdp_init"], float) if "dzdp_init" in trace \
        else None
    out, zo = [], 0
    po = do = 0
    for k in range(model.nsubsystems):
        nn, np_ = model.nn(k), model.np(k)
        p = None if p_all is None else p_all[po:po + np_]
        d = None if d_all is None else d_all[do:do + nn * np_].reshape(nn,
                                                                      np_)
        out.append((p, z[zo:zo + nn], d))
        zo, po, do = zo + nn, po + np_, do + nn * np_
    return out


def host_start(model, trace):
    """Put the host runtime (``runtime.run`` on ``model``) at a trace's
    start: x at x_init, and each subsystem solver's extrapolation origin at
    its part of z_init and its p there (the trace's p_init, else the p that
    x_init and z_init make under the trace's first input).  A trace
    without x_init starts where ``golden_run`` does, the model's own
    start."""
    if "x_init" not in trace:
        return
    model.x[:] = trace["x_init"]
    x = np.asarray(trace["x_init"], float)
    u0 = np.asarray(trace["u"], float)[:, 0]
    z = np.asarray(trace["z_init"], float)
    for k, (p, zk, _) in enumerate(_warm_parts(model, trace)):
        if not model.nn(k):
            continue
        if p is None:
            p = (np.asarray(model.dqs[k], float) @ x
                 + np.asarray(model.eqs[k], float) @ u0
                 + np.asarray(model.fqprevs[k], float) @ z)
        model.solvers[k].set_extrapolation_origin(p, zk)


def engine_start(cm, traces):
    """The scan engine's carry (``CompiledModel`` ``cm``) at the start of
    each of ``traces`` (one lane each, all of ``cm``'s model, all with
    x_init or all without): the engine's own cold start without it
    (``golden_run``'s: x = 0, the model's initial z); else x_init, and
    each subsystem's warm start at its part of z_init with the trace's
    saved p and dz/dp, or, where it saved none, the p that x_init and
    z_init make under the trace's first input and dz/dp evaluated
    there."""
    if "x_init" not in traces[0]:
        return cm.initial_state(len(traces))
    stack = lambda key: np.stack([np.asarray(t[key], float) for t in traces])
    u0 = np.stack([np.asarray(t["u"], float)[:, 0] for t in traces])
    state = cm._state_at(stack("x_init"), stack("z_init"), u0)
    for j, t in enumerate(traces):
        if "p_init" in t:
            for w, (p, _, d) in zip(state["warms"],
                                    _warm_parts(cm.model, t)):
                w.p[j], w.dzdp[j] = cm._as(p), cm._as(d)
    return state


def fused_start(runner, traces, lane_values):
    """A one-model ``FusedRunner``'s state at the start of each of
    ``traces`` (one lane each, ``lane_values`` as ``run`` takes them):
    x_init and z_init centred and balanced as float32 (hi, lo) pairs
    (``FusedRunner._state_at``), the extrapolation origin at the trace's
    saved p and its dz/dp where it saved the engine's (``p_init``,
    ``dzdp_init``), else at the p of the start under the lane's constant
    inputs, with dz/dp evaluated there."""
    stack = lambda key: np.stack([np.asarray(t[key], float) for t in traces])
    state = runner._state_at(stack("x_init"), stack("z_init"), lane_values)
    m = runner.model
    for j, t in enumerate(traces):
        if "p_init" not in t:
            continue
        po = do = 0
        for k, (p, _, d) in enumerate(_warm_parts(m, t)):
            nn, np_ = m.nn(k), m.np(k)
            # the centre's p: the origin is carried relative to it
            pc = (np.asarray(m.dqs[k], float) @ runner.x_ss
                  + np.asarray(m.eqs[k], float) @ runner.u_ss
                  + np.asarray(m.fqprevs[k], float) @ runner.z_ss)
            state["wp"][po:po + np_, j] = runner._tensor(p - pc)
            if nn and np_:
                state["dzdp"][do:do + nn * np_, j] = runner._tensor(
                    d.reshape(-1))
            po, do = po + np_, do + nn * np_
    return state


def fused_point(runner, state):
    """The model-coordinate start of a one-model ``FusedRunner``'s state:
    (x (L, nx), z (L, nn)) float64, each the float64 sum of its float32
    (hi, lo) pair, uncentred (x also unbalanced): x_ss + Tx (x + xlo) and
    z_ss + (z + zlo)."""
    N = lambda key: state[key].detach().cpu().numpy().astype(np.float64).T
    x = runner.x_ss + runner.Tx * (N("x") + N("xlo"))[:, :runner.nx]
    z = runner.z_ss + (N("z") + N("zlo"))[:, :runner.nn_total]
    return x, z
