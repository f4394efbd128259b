"""Host (numpy) runtime: the reference-semantics execution engine.

The port's own copy of ``acme_tpu/runtime.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Implements the per-sample loop of ACME.jl/src/ACME.jl:552-715 plus
steady-state and small-signal linearization (ACME.jl:474-550).  This is the
golden path the device runtimes are validated against: variable
Newton iteration counts, homotopy fallback, solution caching -- exactly the
reference's behaviour, in float64.
"""

from __future__ import annotations

import warnings

import numpy as np

from .model import DiscreteModel
from .solvers import (HomotopySolver, ParametricNonLinEq, SimpleSolver,
                      linearize_solver)

__all__ = ["run", "ModelRunner", "steadystate", "steadystate_",
           "steadystate_sweep", "linearize"]


class ModelRunner:
    """Pre-allocated host runner (ref ACME.jl:570-604)."""

    def __init__(self, model: DiscreteModel, showprogress: bool = False):
        self.model = model
        self.showprogress = showprogress
        self.ucur = np.zeros(model.nu)
        self.ps = [np.zeros(model.np(i)) for i in range(model.nsubsystems)]
        self.ycur = np.zeros(model.ny)
        self.xnew = np.zeros(model.nx)
        self.z = np.zeros(model.nn())

    def run(self, u: np.ndarray, y: np.ndarray = None) -> np.ndarray:
        model = self.model
        u = np.asarray(u, float)
        if u.ndim != 2 or u.shape[0] != model.nu:
            raise ValueError(f"input matrix has {u.shape[0] if u.ndim == 2 else '?'} rows, "
                             f"but model has {model.nu} inputs")
        T = u.shape[1]
        if y is None:
            y = np.zeros((model.ny, T))
        elif y.shape != (model.ny, T):
            raise ValueError("output matrix has wrong shape")
        if not self.showprogress:
            for n in range(T):
                self.step(y, u, n)
            return y
        # progress bar on the hot loop (ref ACME.jl:653 ProgressMeter),
        # throttled to ~4 updates/s so it never dominates the run
        import sys
        import time
        t0 = last = time.time()
        for n in range(T):
            self.step(y, u, n)
            now = time.time()
            if now - last >= 0.25 or n == T - 1:
                last = now
                frac = (n + 1) / T
                bar = "#" * int(30 * frac)
                rate = (n + 1) / max(now - t0, 1e-9)
                eta = (T - n - 1) / max(rate, 1e-9)
                print(f"\rRunning model: {frac:4.0%} |{bar:<30s}| "
                      f"{n + 1}/{T} ({rate:,.0f} smp/s, ETA {eta:4.1f}s)",
                      end="", file=sys.stderr, flush=True)
        print(file=sys.stderr)
        return y

    def step(self, y, u, n):
        """One sample: ordered subsystem solves, output row, state update
        (ref ACME.jl:666-715)."""
        model = self.model
        self.ucur[:] = u[:, n]
        z = self.z
        z[:] = 0.0
        zoff = 0
        for idx in range(model.nsubsystems):
            p = self.ps[idx]
            if model.dqs[idx].shape[1] == 0:
                p[:] = 0.0
            else:
                p[:] = model.dqs[idx] @ model.x
            p += model.eqs[idx] @ self.ucur
            if idx > 0:
                p += model.fqprevs[idx] @ z
            zsub = model.solvers[idx].solve(p)
            if not model.solvers[idx].hasconverged():
                if np.all(np.isfinite(zsub)):
                    warnings.warn("Failed to converge while solving non-linear equation.")
                else:
                    raise RuntimeError("Failed to converge while solving non-linear "
                                       "equation, got non-finite result.")
            nn_i = model.nn(idx)
            z[zoff:zoff + nn_i] = zsub
            zoff += nn_i
        if model.ny > 0:
            self.ycur[:] = model.y0
            self.ycur += model.dy @ model.x
            self.ycur += model.ey @ self.ucur
            self.ycur += model.fy @ z
            y[:, n] = self.ycur
        if model.nx > 0:
            self.xnew[:] = model.x0
            self.xnew += model.a @ model.x
            self.xnew += model.b @ self.ucur
            self.xnew += model.c @ z
            model.x[:] = self.xnew


def run(model: DiscreteModel, u: np.ndarray, showprogress: bool = False) -> np.ndarray:
    """Run ``model`` on input ``u`` (one row per circuit input, one column per
    sample); returns the outputs in the same layout.  Model state is
    preserved across calls (ref ACME.jl:552-568)."""
    return ModelRunner(model, showprogress).run(u)


def steadystate(model: DiscreteModel, u=None, return_z: bool = False):
    """Steady-state state vector for constant input u (ref ACME.jl:474-497).

    With ``return_z`` also returns the steady nonlinear solution vector
    (used by the float32 fused runtime for operating-point centering)."""
    if u is None:
        u = np.zeros(model.nu)
    u = np.asarray(u, float)
    IA = np.eye(model.nx) - model.a
    steady_z = np.zeros(model.nn())
    zoff = 0
    for idx in range(model.nsubsystems):
        nn_i = model.nn(idx)
        zr = slice(zoff, zoff + nn_i)
        # dq/IA means dq @ inv(IA)
        dqIA = np.linalg.solve(IA.T, model.dqs[idx].T).T if model.nx > 0 \
            else np.zeros((model.np(idx), 0))
        steady_q0 = (model.q0s[idx]
                     + model.pexps[idx] @ ((dqIA @ model.b + model.eqs[idx]) @ u
                                           + (dqIA @ model.c + model.fqprevs[idx]) @ steady_z)
                     + (model.pexps[idx] @ dqIA @ model.x0 if model.nx > 0 else 0.0))
        fq_eff = (model.pexps[idx] @ dqIA @ model.c[:, zr] if model.nx > 0 else 0.0) \
            + model.fqs[idx]
        nl = model.nl_funcs[idx]

        def func(res, J, scratch, z, fq_eff=fq_eff, nl=nl):
            pfull = scratch[0]
            q = pfull + fq_eff @ z
            r, Jq = nl(np, q)
            res[:] = r
            scratch[1][:] = Jq
            J[:] = Jq @ fq_eff

        nleq = ParametricNonLinEq(func, nn=nn_i, np_=model.nq(idx))
        solver = HomotopySolver(nleq, np.zeros(model.nq(idx)), np.zeros(nn_i),
                                base=SimpleSolver)
        solver.set_resabstol(1e-15)
        steady_z[zr] = solver.solve(steady_q0)
        if not solver.hasconverged():
            raise RuntimeError("Failed to find steady state solution")
        zoff += nn_i
    xs = np.linalg.solve(IA, model.b @ u + model.c @ steady_z + model.x0) \
        if model.nx > 0 else np.zeros(0)
    if return_z:
        return xs, steady_z
    return xs


def operating_point(model: DiscreteModel, u=None, resabstol=1e-9,
                    runin=2048):
    """Approximate steady operating point (x, z) for constant input ``u``,
    for float32 operating-point centering (ops/fused.py).

    Differs from :func:`steadystate` (the reference-faithful path,
    ACME.jl:474-497) in robustness and *branch selection*, not meaning --
    centering is exact for ANY center point, so this only needs to land
    near the trajectory, but it must land on the trajectory's solution
    BRANCH (a steady solve homotopied from zero can converge to a
    different root of a weakly-determined subsystem -- the dead-zone diode
    trio of the chain-decomposed superover -- and a wrong-root center
    poisons every fused warm start).  Approach:

    1. **Run-in**: run the real dynamics for ``runin`` samples at constant
       ``u`` -- on-branch by construction; gives (x_run, z_run).
    2. **Warm steady solve**: per-subsystem Newton started at z_run (no
       homotopy restart from zero), so it converges to the *nearby* root;
       a non-converged subsystem keeps its run-in value instead of
       raising.
    3. **Null-mode handling**: eigenvalue-1 modes of A (a capacitor across
       a stiff source leaves an undriven state: the reference's own steady
       state is broken there, test/runtests.jl:763-764 @test_broken) are
       constants of motion; their center value is matched to the
       trajectory (w^T x = w^T x_run for left null vectors w of I - A)
       rather than chosen minimum-norm.
    """
    if u is None:
        u = np.zeros(model.nu)
    u = np.asarray(u, float)
    nx = model.nx

    # 1. run-in (state is restored; solver warm origins legitimately move)
    x_run = np.zeros(nx)
    z_run = np.zeros(model.nn())
    if runin and (nx or model.nn()):
        x_save = model.x.copy()
        try:
            model.x[:] = 0.0
            runner = ModelRunner(model)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                runner.run(np.ascontiguousarray(
                    np.broadcast_to(u[:, None], (model.nu, int(runin)))))
            x_run = model.x.copy()
            z_run = runner.z.copy()
        except Exception:
            x_run = np.zeros(nx)
            z_run = np.zeros(model.nn())
        finally:
            model.x[:] = x_save

    # trajectory-matched affine solve X(rhs) with (I-A) X = rhs and
    # w^T X = w^T x_run on the left null space:
    #   X(rhs) = (M - K M) rhs + K x_run,  M = pinv(I-A),
    #   K = N (W^T N)^{-1} W^T  (N/W right/left null bases)
    if nx:
        IA = np.eye(nx) - np.asarray(model.a, float)
        U_, s_, Vt_ = np.linalg.svd(IA)
        cutoff = max(IA.shape) * np.finfo(float).eps * (s_[0] if s_.size else 1.0)
        rank = int(np.sum(s_ > cutoff))
        M = (Vt_[:rank].T / s_[:rank]) @ U_[:, :rank].T
        if rank < nx:
            N_ = Vt_[rank:].T
            W_ = U_[:, rank:]
            K = N_ @ np.linalg.solve(W_.T @ N_, W_.T)
            MM = M - K @ M
            x_off = K @ x_run
        else:
            MM = M
            x_off = np.zeros(nx)
    else:
        MM = np.zeros((0, 0))
        x_off = np.zeros(0)

    # 2. z center = the run-in value itself.  A warm per-subsystem steady
    # refinement was tried and REVERTED: the (I-A)^-1-folded steady system
    # has spurious fixed points (non-physical DK roots: the refined point
    # held y = 3.23 V where the trajectory's steady output is 0), and
    # Newton on the folded system hops to them even from a near-trajectory
    # start.  The run-in value is within the remaining-transient distance
    # of steady, which centering tolerates by construction.
    steady_z = z_run
    # x center = trajectory-matched fixed point of the LINEAR part at
    # z = z_run (projects out the already-settled linear transient)
    xs = (MM @ (model.b @ u + model.c @ steady_z + model.x0) + x_off) \
        if nx else np.zeros(0)
    return xs, steady_z


def steadystate_(model: DiscreteModel, u=None) -> np.ndarray:
    """steadystate! of the reference: also installs the state (ACME.jl:499-503)."""
    xs = steadystate(model, u)
    model.x[:] = xs
    return xs


def _solve_sub_batch(model, idx, p, z0, tol=1e-10, maxiter=200):
    """Warm-started batched Newton for one nonlinear subsystem over a lane
    axis: ``p`` (np_k, L), ``z0`` (nn_k, L) -> (z, conv (L,), Jq at z).

    The lane-batched counterpart of the per-sample solve inside
    :meth:`ModelRunner.step` (ref ACME.jl:675-697 / solvers.jl:207-236):
    plain Newton, no homotopy -- callers provide on-branch warm starts
    (previous sample / previous continuation point), which is the same
    contract the reference's extrapolation origin provides."""
    nl = model.nl_funcs[idx]
    pexp = np.asarray(model.pexps[idx], float)
    fq = np.asarray(model.fqs[idx], float)
    q0 = np.asarray(model.q0s[idx], float)
    nn_k = model.nn(idx)
    L = p.shape[1]
    if nn_k == 0:
        return (np.zeros((0, L)), np.ones(L, bool),
                np.zeros((0, model.nq(idx), L)))
    pfull = q0[:, None] + pexp @ p
    z = np.array(z0, float)
    best_z = z.copy()
    best_r = np.full(L, np.inf)
    conv = np.zeros(L, bool)
    since_imp = np.zeros(L, np.int32)
    tsc_best = np.full(L, np.inf)
    Jq = np.zeros((nn_k, model.nq(idx), L))
    with np.errstate(all="ignore"):
        for _ in range(maxiter):
            q = pfull + fq @ z
            res, Jq_new = nl(np, q)
            finite = np.isfinite(res).all(0)
            resmax = np.where(finite, np.abs(res).max(0), np.inf)
            improved = resmax < best_r
            best_r = np.where(improved, resmax, best_r)
            best_z[:, improved] = z[:, improved]
            Jq[..., improved] = Jq_new[..., improved]
            since_imp = np.where(improved, 0, since_imp + 1)
            # floor-stall acceptance: a lane stuck just above the
            # absolute tolerance at its f64 evaluation floor counts as
            # solved (mirrors the fused kernel's stall semantics).  The
            # floor follows the residual's cancelling term magnitudes,
            # sum_c |Jq| |q| per row -- measured at the BEST point only:
            # a diverging live iterate inflates its own term scale and
            # would self-certify garbage (the same trap the fused
            # kernel's relative gates guard against).
            tscale = np.einsum("ijl,jl->il", np.abs(Jq_new),
                               np.abs(q)).max(0) if nn_k else 0.0
            tsc_best = np.where(improved, tscale, tsc_best)
            floor = np.maximum(64.0 * tol, 1e-12 * tsc_best)
            conv = (best_r < tol) | ((since_imp >= 3) & (best_r < floor))
            active = finite & ~conv
            if not active.any():
                break
            # J = Jq @ fq per lane; batched solve with pinv fallback
            J = np.einsum("ijl,jk->lik", Jq_new, fq)
            r_l = res.T[:, :, None]
            try:
                step = np.linalg.solve(J, r_l)[:, :, 0].T
            except np.linalg.LinAlgError:
                step = (np.linalg.pinv(J) @ r_l)[:, :, 0].T
            step = np.where(np.isfinite(step), step, 0.0)
            # scale down super-sized steps (the host leans on homotopy
            # here; warm-started continuation keeps these rare).  The
            # clip must stay well above legitimate z magnitudes (pot-row
            # unknowns reach ~100 in these circuits) or near-singular
            # lanes crawl instead of converging.
            smax = np.abs(step).max(0)
            scale = np.where(smax > 100.0, 100.0 / np.maximum(smax, 1e-30),
                             1.0)
            z = np.where(active, z - step * scale, best_z)
    return best_z, conv, Jq


def steadystate_sweep(model: DiscreteModel, u_lanes, runin: int = 4096,
                      rounds: int = 12, ramp: int = 64, attempts: int = 3,
                      solve_tol: float = 1e-10, host_verify: int = 16,
                      return_floors: bool = False):
    """Per-lane steady states for a batch of constant inputs.

    Lane-parallel counterpart of :func:`steadystate` (ref ACME.jl:474-497)
    for L lanes sharing the model matrices and differing only in the
    constant input vector (pot positions, trims): returns
    ``(x (L, nx), z (L, nn), converged (L,))``.

    Branch safety: the reference's steady solve homotopies each subsystem
    from zero through the (I-A)^-1-folded system, which has spurious
    non-physical fixed points the reference itself trips over
    (test/runtests.jl:763-764 @test_broken; see
    :func:`operating_point`).  This routine never solves the folded
    system.  Instead, per attempt:

    1. **Ramped dynamics run-in** (lane-vectorized): run the true
       per-sample map at constant input, ramping the input from the
       lane-mean to each lane's value over ``ramp`` samples -- on the
       trajectory's solution branch by construction.
    2. **Newton on the one-sample map** ``g(x) = f(x) - x`` with z
       warm-tracked from the run-in values: the Jacobian
       ``df/dx = A + sum_k C_k dz_k/dx`` chains per-subsystem
       sensitivities dz/dp = -(Jq Fq)^{-1} (Jq Pexp) through the Fqprev
       couplings exactly as :func:`linearize` does (ACME.jl:529-539).
       Eigenvalue-1 modes of A (pinned bias rails) are conserved only
       for the linear part -- the nonlinearity feeds them back with a
       huge time constant (~30k samples measured on the chain-decomposed
       superover), so Newton jumps the whole slow tail in one step;
       genuinely conserved directions are dropped by the pinv rank
       cutoff.  Steps are backtracked and guarded by z-continuity
       against carrying the warm-tracked z across a root-basin boundary.
    3. **Drift verification**: run the true dynamics from the candidate
       (z warm-started from the RUN-IN branch, so a root unreachable
       from the host's branch cannot hold still); keep the candidate
       only if it is at least as quiet as the run-in baseline, and --
       when the baseline is itself settled -- only if its output agrees
       with the baseline's (a latched wrong operating point passes every
       residual and drift test but sits at a different output).

    Non-certified lanes extend the run-in and retry (``attempts``
    rounds, doubling); the best-drift state per lane is returned with
    ``converged`` reporting whether its verified output drift is below
    1e-7 of the circuit's signal scale."""
    u_lanes = np.asarray(u_lanes, float)
    if u_lanes.ndim != 2 or u_lanes.shape[1] != model.nu:
        raise ValueError(f"u_lanes must be (L, {model.nu}), "
                         f"got {u_lanes.shape}")
    L = u_lanes.shape[0]
    nx, nsub = model.nx, model.nsubsystems
    nn_tot = model.nn()
    a = np.asarray(model.a, float)
    b = np.asarray(model.b, float)
    c = np.asarray(model.c, float)
    x0 = np.asarray(model.x0, float)
    uT = u_lanes.T
    zr = []
    off = 0
    for k in range(nsub):
        zr.append(slice(off, off + model.nn(k)))
        off += model.nn(k)

    def _ret(x_out, z_out, conv_out, floors_out=None):
        if return_floors:
            if floors_out is None:
                floors_out = np.zeros((L, max(nsub, 1)))
            return x_out, z_out, conv_out, floors_out
        return x_out, z_out, conv_out

    if nn_tot == 0:
        # linear model: exact direct solve (lstsq for conserved modes)
        if nx == 0:
            return _ret(np.zeros((L, 0)), np.zeros((L, 0)),
                        np.ones(L, bool))
        rhs = b @ uT + x0[:, None]
        x = np.linalg.lstsq(np.eye(nx) - a, rhs, rcond=None)[0]
        return _ret(x.T, np.zeros((L, 0)), np.ones(L, bool))

    def track_z(x, z, ut, detail=False):
        """One chain of warm-started subsystem solves at state x, input
        ut; returns (z, conv, Jq list).  With ``detail``, also returns
        per-subsystem (conv, stationary, residual-floor) arrays -- the
        basis of the certified-with-floor contract below."""
        z = z.copy()
        conv = np.ones(L, bool)
        Jqs = []
        sub_ok = np.ones((nsub, L), bool)
        sub_stat = np.ones((nsub, L), bool)
        floors = np.zeros((nsub, L))
        for k in range(nsub):
            p = (np.asarray(model.dqs[k], float) @ x
                 + np.asarray(model.eqs[k], float) @ ut
                 + np.asarray(model.fqprevs[k], float) @ z)
            z_in = z[zr[k]].copy()
            zk, ck, Jq = _solve_sub_batch(model, k, p, z[zr[k]],
                                          tol=solve_tol)
            z[zr[k]] = zk
            conv &= ck
            Jqs.append(Jq)
            if detail:
                sub_ok[k] = ck
                if model.nn(k):
                    sub_stat[k] = (np.abs(zk - z_in).max(0)
                                   <= 1e-9 * (1.0 + np.abs(zk).max(0)))
                    q = (np.asarray(model.q0s[k], float)[:, None]
                         + np.asarray(model.pexps[k], float) @ p
                         + np.asarray(model.fqs[k], float) @ zk)
                    with np.errstate(all="ignore"):
                        res, _ = model.nl_funcs[k](np, q)
                    floors[k] = np.abs(res).max(0) if model.nn(k) else 0.0
        if detail:
            return z, conv, Jqs, sub_ok, sub_stat, floors
        return z, conv, Jqs

    u_mean = u_lanes.mean(axis=0)

    def dyn_steps(x, z, n, ramp_from=None):
        for t in range(n):
            if ramp_from is not None and ramp:
                s = min(1.0, (t + 1) / ramp)
                ut = ramp_from[:, None] + s * (uT - ramp_from[:, None])
            else:
                ut = uT
            z, _, _ = track_z(x, z, ut)
            if nx:
                x = a @ x + b @ ut + c @ z + x0[:, None]
        return x, z

    x = np.zeros((nx, L))
    z = np.concatenate([np.asarray(zk, float) for zk in model.init_zs]) \
        .reshape(nn_tot, 1) * np.ones((1, L))
    x, z = dyn_steps(x, z, runin, ramp_from=u_mean)

    if nx == 0:
        z, conv, _, sub_ok, sub_stat, floors = track_z(x, z, uT,
                                                       detail=True)
        cert = (sub_ok | (sub_stat & np.isfinite(floors))).all(0)
        return _ret(x.T, z.T, conv | cert, floors.T)

    # Per-state scale for the Newton residual measure: include |f(x)|
    # along with |x| -- eigenvalue -1 modes of A (undamped sample-rate
    # alternation, a trapezoidal-discretization artifact of stiff nodes)
    # sit at x = 0 on one phase of their period-2 cycle while |f(x)| is
    # the full alternation amplitude; Newton lands them on the cycle's
    # true fixed point in one step, but the scale must not read 0.
    z_sc, _, _ = track_z(x, z, uT)
    xnext_sc = a @ x + b @ uT + c @ z_sc + x0[:, None]
    scale = np.maximum(np.abs(x).max(axis=1), np.abs(xnext_sc).max(axis=1))
    scale = np.maximum(scale, scale.max() * 1e-6 + 1e-300)

    # The observable scale for all acceptance gates must be the
    # circuit's SIGNAL scale, not the quiescent output (which is ~0 with
    # the audio input at its center, so nanovolt-level jitter would trip
    # every gate).  Junction drops in z and the constant inputs measure
    # it directly -- the same volt-ish anchor the reference's own
    # absolute tolerances assume (solvers.jl:175, ACME.jl:489).
    vref = max(float(np.abs(z).max()) if nn_tot else 0.0,
               float(np.abs(uT).max()) if uT.size else 0.0, 1e-300)

    def jf_at(x, z):
        """One tracked step: returns (Jf = A + sum_k C_k dz_k/dx at x,
        dzdx list, z at x, f(x), solve-certified flags)."""
        z2, conv, Jqs = track_z(x, z, uT)
        dzdx = []
        for k in range(nsub):
            Jq = Jqs[k]                           # (nn_k, nq_k, L)
            fq = np.asarray(model.fqs[k], float)
            pexp = np.asarray(model.pexps[k], float)
            with np.errstate(all="ignore"):
                Jl = np.einsum("ijl,jk->lik", Jq, fq)
                Jp = np.einsum("ijl,jk->lik", Jq, pexp)
                dzdp = -np.linalg.pinv(Jl) @ Jp   # (L, nn_k, np_k)
            dpdx = np.broadcast_to(
                np.asarray(model.dqs[k], float)[None],
                (L, model.np(k), nx)).copy()
            fqprev = np.asarray(model.fqprevs[k], float)
            for j in range(k):
                fsub = fqprev[:, zr[j]]
                if fsub.any():
                    dpdx += np.einsum("ij,ljk->lik", fsub, dzdx[j])
            dzdx.append(dzdp @ dpdx)              # (L, nn_k, nx)
        Jf = np.broadcast_to(a[None], (L, nx, nx)).copy()
        for k in range(nsub):
            ck = c[:, zr[k]]
            if ck.size:
                Jf += np.einsum("ij,ljk->lik", ck, dzdx[k])
        xn = a @ x + b @ uT + c @ z2 + x0[:, None]
        return Jf, dzdx, z2, xn, conv

    def gmeas2(x, z):
        """DOUBLE-sample map residual g2(x) = f(f(x)) - x with the
        chained Jacobian Jg2 = Jf(f(x)) Jf(x) - I.  The double map is the
        right fixed-point problem: eigenvalue -1 modes of A (undamped
        period-2 alternation) have no fixed point of f at all -- under
        f^2 their amplitude is a conserved quantity that the pinv rank
        cutoff drops, so Newton settles the slow feedback modes while
        leaving the on-orbit alternation phase alone."""
        Jf0, dzdx0, z1, x1, c0 = jf_at(x, z)
        Jf1, _, z2_, x2, c1 = jf_at(x1, z1)
        g = x2 - x
        gn = (np.abs(g) / scale[:, None]).max(axis=0)
        Jg = Jf1 @ Jf0 - np.eye(nx)[None]
        return g, gn, Jg, dzdx0, z1, z2_, c0 & c1

    dyv = np.asarray(model.dy, float)
    eyv = np.asarray(model.ey, float)
    fyv = np.asarray(model.fy, float)
    y0v = np.asarray(model.y0, float)

    def verify(x0v, z0v, V=64):
        """Run V true-dynamics samples; returns (output drift, final x,
        final z, first-sample output, all-solves-certified flag).  The
        flag matters: a Newton candidate can sit at a point where a
        subsystem is only solvable to ~1e-4 (the alternating-mode cycle
        MIDPOINT of the chain model) -- quiet in y, but seeding a
        solver warm start there costs a homotopy grind per sample."""
        xv, zv = x0v.copy(), z0v.copy()
        ys = []
        for _ in range(V):
            zv, cv, _ = track_z(xv, zv, uT)
            if model.ny:
                ys.append(dyv @ xv + eyv @ uT + fyv @ zv + y0v[:, None])
            xv = a @ xv + b @ uT + c @ zv + x0[:, None]
        if model.ny:
            ys = np.stack(ys)                      # (V, ny, L)
            # period-2-aware: eigenvalue -1 modes of A (trapezoidal
            # artifact) make the settled object a period-2 orbit for some
            # circuits; compare samples two apart so the settled
            # alternation does not read as drift
            drift = np.abs(ys[2:] - ys[:-2]).max(axis=(0, 1)) \
                if len(ys) > 2 else np.abs(ys - ys[0]).max(axis=(0, 1))
            yfirst = ys[0]
        else:
            drift = (np.abs(xv - x0v) / scale[:, None]).max(axis=0)
            yfirst = np.zeros((0, L))
        return drift, xv, zv, yfirst

    def newton_rounds(x, z):
        """Guarded Newton on the double-sample map g2(x) = f(f(x)) - x
        (see gmeas2); returns the candidate (x, z-at-x)."""
        g, gn, Jg, dzdx0, z, _, _ = gmeas2(x, z)
        gtol_rel = 1e-11
        with np.errstate(all="ignore"):
            for _ in range(rounds):
                done = gn <= gtol_rel
                if done.all():
                    break
                # rank-cutoff pinv step (genuinely conserved directions
                # -- undriven states, on-orbit alternation phase -- drop)
                step = (np.linalg.pinv(Jg, rcond=1e-12)
                        @ g.T[:, :, None])[:, :, 0].T
                step = np.where(np.isfinite(step), step, 0.0)
                # Backtracking with a BRANCH GUARD: the per-sample system
                # is multi-root for some circuits; a Newton step in x can
                # carry the warm-tracked z across a basin boundary, after
                # which |g| happily shrinks toward a *different orbit's*
                # fixed point.  The actual z at the stepped x must agree
                # with its own linear prediction z + dz/dx . dx to within
                # a fraction of the z scale -- a hop violates that.
                zsc = np.maximum(np.abs(z).max(axis=0), 1.0)
                accepted = np.zeros(L, bool)
                for t in (1.0, 0.5, 0.25, 0.125):
                    trial = ~done & ~accepted
                    if not trial.any():
                        break
                    dx = -t * step
                    x_try = np.where(trial, x + dx, x)
                    zpred = z.copy()
                    for k in range(nsub):
                        zpred[zr[k]] += np.einsum("lij,jl->il",
                                                  dzdx0[k], dx)
                    (g2, gn2, Jg2, dzdx2, z2, _, _) = gmeas2(x_try, zpred)
                    cont = (np.abs(z2 - zpred).max(axis=0) / zsc) < 0.1
                    ok = trial & (gn2 < (1.0 - 0.05 * t) * gn) & cont \
                        & np.isfinite(x_try).all(0)
                    if not ok.any():
                        continue
                    x = np.where(ok, x_try, x)
                    g = np.where(ok[None, :], g2, g)
                    gn = np.where(ok, gn2, gn)
                    z = np.where(ok[None, :], z2, z)
                    Jg = np.where(ok[:, None, None], Jg2, Jg)
                    for k in range(nsub):
                        dzdx0[k] = np.where(ok[:, None, None], dzdx2[k],
                                            dzdx0[k])
                    accepted |= ok
                if (~accepted & ~done).any():
                    # stubborn lanes: a few true dynamics steps instead
                    # (a no-op for lanes already at their fixed point)
                    x, z = dyn_steps(x, z, 8)
                    g, gn, Jg, dzdx0, z, _, _ = gmeas2(x, z)
        return x, z

    import os as _os
    debug = bool(_os.environ.get("ACME_SSWEEP_DEBUG"))
    best_x = best_z = None
    best_drift = np.full(L, np.inf)
    x_run, z_run = x, z
    for attempt in range(max(attempts, 1)):
        xn, zn = newton_rounds(x_run, z_run)
        drift_n, _, z_nv, y_n = verify(xn, z_run)
        drift_r, x_rv, z_rv, y_r = verify(x_run, z_run)
        # candidate solvability: tracked from the candidate's OWN z (the
        # verify above warm-starts from the run-in branch on purpose, so
        # its solves stall for ANY legitimate big jump).  This is what
        # rejects the alternating-mode cycle midpoint, where a subsystem
        # is only solvable to ~1e-4 -- quiet in y, but a homotopy grind
        # per sample for any consumer seeded there.
        _, cert_n, _ = track_z(xn, zn, uT)
        # per-lane slow-mode time constant from the BASELINE Jacobian
        # (on-branch by construction): tau = -1/ln|lam_slowest|, with
        # conserved / alternating modes (|lam| ~ 1) excluded and tau
        # capped at 1e6 samples
        Jf_b, _, _, _, _ = jf_at(x_run, z_run)
        with np.errstate(all="ignore"):
            ev = np.abs(np.linalg.eigvals(Jf_b))          # (L, nx)
        lam = np.where(ev < 1.0 - 1e-7, ev, 0.0).max(axis=1)
        tau = np.where(lam > 0,
                       -1.0 / np.log(np.maximum(lam, 1e-12)), 64.0)
        # cap: 2e5 samples covers every measured slow mode (the chain
        # superover bias rail: 30k-150k across the pot grid).  An
        # uncapped tau lets a dead-zone corner lane (genuinely bistable:
        # the host's root selection diverges from the tracked dynamics
        # only samples later) slip a wrong operating point through the
        # gate; with the cap those lanes stay honest conv=False and the
        # caller's power-up machinery settles them dynamically.
        tau = np.clip(np.where(np.isfinite(tau), tau, 64.0), 64.0, 2e5)
        # Acceptance: candidate at least as quiet as the baseline, AND
        # output-consistent with it.  The consistency bound follows from
        # the transient physics: a slow mode A lam^t with time constant
        # tau shows a baseline drift of about A (V / tau) over the
        # V=64-sample verify window, so the LEGITIMATE jump a refinement
        # can make (removing the remaining transient, amplitude A) is
        # bounded by (tau / V) drift_r -- with tau estimated PER LANE
        # from the baseline Jacobian above (the chain superover's bias
        # rail measures tau ~ 30k-150k samples depending on the pots).
        # A candidate further away than 8x that bound is a latched wrong
        # operating point -- measured on the drive=0.05 pot corner: a
        # root 10 V away in y that the candidate's own tracked dynamics
        # holds but the host's solver chain walks away from.
        dy_nr = np.abs(y_n - y_r).max(axis=0) if model.ny \
            else np.zeros(L)
        if debug:                                   # pragma: no cover
            print("SSWEEP vref:", vref, "\n drift_n:", drift_n,
                  "\n drift_r:", drift_r, "\n dy_nr:", dy_nr,
                  "\n cert_n:", cert_n)
        consistent = dy_nr <= 8.0 * drift_r * tau / 64.0 + 1e-6 * vref
        keep_n = consistent & cert_n \
            & (drift_n <= np.maximum(drift_r, 1e-8 * vref)) \
            & np.isfinite(xn).all(0) & np.isfinite(z_nv).all(0)
        x_att = np.where(keep_n, xn, x_rv)
        z_att = np.where(keep_n[None, :], z_nv, z_rv)
        drift_att = np.where(keep_n, drift_n, drift_r)
        better = drift_att < best_drift
        if best_x is None:
            best_x, best_z, best_drift = x_att, z_att, drift_att
        else:
            best_x = np.where(better, x_att, best_x)
            best_z = np.where(better[None, :], z_att, best_z)
            best_drift = np.where(better, drift_att, best_drift)
        if (best_drift <= 1e-7 * vref).all() or attempt == attempts - 1:
            break
        # extend the run-in (doubling) from the advanced baseline --
        # never from the Newton candidate, whose branch is unverified
        x_run, z_run = dyn_steps(x_rv, z_rv, runin * (2 ** attempt))
    # Return a CONSISTENT (x, z) pair: re-track z at the final x (the
    # verification advanced its z along the trajectory, and for the
    # Newton-jumped alternating modes the candidate x is the cycle
    # midpoint while that z belongs to a phase -- consumers seed solver
    # warm starts with this pair, and an inconsistent one costs them a
    # homotopy grind on the very first sample).
    (best_z, convz_f, _, sub_ok, sub_stat,
     floors) = track_z(best_x, best_z, uT, detail=True)
    # CERTIFIED-WITH-FLOOR.  The chain-decomposed superover's exact
    # steady state contains a dead-zone subsystem whose residual floor
    # is ~4e-4 -- NO solver can reach tolerance there (this is precisely
    # why the reference marks this model's steady state @test_broken,
    # test/runtests.jl:763-764): measured root cause, both junctions of
    # the bias pair strongly reverse-biased, the residual's local
    # minimum is ~4e-4 in every direction, J near-singular, and the
    # OUTPUT is insensitive to the undetermined z direction (drift
    # ~1e-19).  Round 3 refused to certify such lanes ("solvability is
    # part of the contract") to protect consumers from seeding warm
    # starts that grind a futile rescue ladder per sample -- which made
    # powerup='steady' useless on the pots grid (677/4096 lanes
    # certified).  The honest contract is finer: a subsystem is
    # certified either by the solver (sub_ok) or by being genuinely
    # FLOORED -- the warm solve left z stationary, so no better point
    # exists for this solver -- with the measured residual floor
    # RETURNED (``return_floors``) so consumers gate their own solvers
    # at it instead of grinding.  Root selection is still arbitrated by
    # the host run below.
    cert_sub = sub_ok | (sub_stat & np.isfinite(floors))
    conv = (best_drift <= 1e-7 * vref) & cert_sub.all(0) \
        & np.isfinite(best_x).all(0) & np.isfinite(best_z).all(0)
    if debug:                                       # pragma: no cover
        print("SSWEEP final: drift:", best_drift, "convz_f:", convz_f,
              "pre-host conv:", conv)
    # FINAL ARBITER: the host solver chain itself.  At dead-zone pot
    # corners the per-sample system is bistable at the SOLVER level: the
    # batched warm-tracked dynamics can latch a root (zero drift,
    # self-consistent in every internal test) that the host's
    # Homotopy/Caching solver chain walks away from samples later --
    # measured: a y = +0.5 V latch at drive=0.05 where the true quiet
    # output is 0.  Nothing vectorized reproduces the host's root
    # selection, so certification ends with a short per-lane HOST run
    # (``host_verify`` samples; ~ms per lane): lanes whose host
    # trajectory moves off the returned state lose their conv flag (the
    # state is still returned -- near-steady -- and the caller's
    # power-up machinery settles it on the host branch).
    if host_verify and model.ny and conv.any():
        tol_h = 32.0 * 1e-7 * vref
        # The host run gets 3x the window with the drift gate applied to
        # the LAST host_verify samples only: at stiff pot end-stops the
        # host solver chain lands on a slightly different z than the
        # batch dynamics on sample 1, exciting a small (~1e-5-relative,
        # tau ~ 1e3-sample) transient that RELAXES -- solver noise, not a
        # root walk-away (measured on the drive=tone=1.0 chain superover:
        # a 1e-4 V excursion decaying back toward the candidate).  A
        # genuine wrong-root latch still fails: its output offset
        # (measured 0.5-10 V) trips agree_h, and a slow walk-away keeps
        # drifting in the tail window.
        V_h = 3 * int(host_verify)
        y_cand = dyv @ best_x + eyv @ uT + fyv @ best_z + y0v[:, None]
        x_save = model.x.copy()
        tol_save = [getattr(s, "resabstol",
                            getattr(getattr(s, "basesolver", None),
                                    "resabstol", 1e-10))
                    for s in model.solvers]
        try:
            for i in range(L):
                if not conv[i]:
                    continue
                model.x[:] = best_x[:, i]
                # floor-aware verification: at a floored (dead-zone)
                # subsystem the host solver cannot do better than the
                # measured floor either -- raising its tolerance to the
                # floor keeps the check fast (no per-sample rescue
                # grind) while a wrong-root latch still fails agree_h
                # (its output is off by far more than the floor)
                for k, s in enumerate(model.solvers):
                    s.set_resabstol(max(tol_save[k], 4.0 * floors[k, i]))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    yh = ModelRunner(model).run(np.ascontiguousarray(
                        np.broadcast_to(u_lanes[i][:, None],
                                        (model.nu, V_h))))
                tail = yh[:, -int(host_verify):]
                drift_h = np.abs(tail[:, 2:] - tail[:, :-2]).max() \
                    if tail.shape[1] > 2 else 0.0
                agree_h = np.abs(yh[:, 0] - y_cand[:, i]).max()
                if debug:                           # pragma: no cover
                    print(f"SSWEEP host lane {i}: drift_h={drift_h:.2e} "
                          f"agree_h={agree_h:.2e} tol={tol_h:.2e}")
                conv[i] = bool((drift_h <= tol_h) & (agree_h <= tol_h))
        finally:
            model.x[:] = x_save
            for k, s in enumerate(model.solvers):
                s.set_resabstol(tol_save[k])
    if return_floors:
        return best_x.T, best_z.T, conv, floors.T
    return best_x.T, best_z.T, conv


def linearize(model: DiscreteModel, usteady=None) -> DiscreteModel:
    """Solver-free small-signal model around the steady state
    (ref ACME.jl:505-550)."""
    if usteady is None:
        usteady = np.zeros(model.nu)
    usteady = np.asarray(usteady, float)
    xsteady = steadystate(model, usteady)
    nsub = model.nsubsystems
    zranges = [None] * nsub
    dzdps = [None] * nsub
    dqlins = [None] * nsub
    eqlins = [None] * nsub
    zsteady = np.zeros(model.nn())
    zoff = 0
    x0 = model.x0.copy()
    a = model.a.copy()
    b = model.b.copy()
    y0 = model.y0.copy()
    dy = model.dy.copy()
    ey = model.ey.copy()

    for idx in range(nsub):
        psteady = (model.dqs[idx] @ xsteady + model.eqs[idx] @ usteady
                   + model.fqprevs[idx] @ zsteady)
        zsub, dzdps[idx] = linearize_solver(model.solvers[idx], psteady)
        nn_i = len(zsub)
        zsteady[zoff:zoff + nn_i] = zsub
        zranges[idx] = slice(zoff, zoff + nn_i)

        fqdzdps = [model.fqprevs[idx][:, zranges[n]] @ dzdps[n] for n in range(idx)]
        dqlins[idx] = model.dqs[idx] + sum((f @ d for f, d in zip(fqdzdps, dqlins[:idx])),
                                           np.zeros_like(model.dqs[idx]))
        eqlins[idx] = model.eqs[idx] + sum((f @ d for f, d in zip(fqdzdps, eqlins[:idx])),
                                           np.zeros_like(model.eqs[idx]))

        x0 += model.c[:, zranges[idx]] @ (zsub - dzdps[idx] @ psteady)
        a += model.c[:, zranges[idx]] @ dzdps[idx] @ dqlins[idx]
        b += model.c[:, zranges[idx]] @ dzdps[idx] @ eqlins[idx]

        y0 += model.fy[:, zranges[idx]] @ (zsub - dzdps[idx] @ psteady)
        dy += model.fy[:, zranges[idx]] @ dzdps[idx] @ dqlins[idx]
        ey += model.fy[:, zranges[idx]] @ dzdps[idx] @ eqlins[idx]

        zoff += nn_i

    mats = {"a": a, "b": b, "c": np.zeros((model.nx, 0)), "x0": x0,
            "dy": dy, "ey": ey, "fy": np.zeros((model.ny, 0)), "y0": y0,
            "pexps": [], "dqs": [], "eqs": [], "fqprevs": [], "fqs": [],
            "q0s": []}
    return DiscreteModel(_mats=mats, _nl_funcs=[], _solvers=[])
