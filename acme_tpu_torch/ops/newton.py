"""Per-lane Newton solver with extrapolated warm start and homotopy fallback
(``acme_tpu/ops/newton.py``), written over a lane axis in torch.

This is the plain version of the float64 scan engine's solve: the JAX
package writes it for one lane and vmaps it, its ``lax.while_loop``\\ s
masked per lane; here every function takes a leading lane axis and each
loop runs on the lanes that are still live (compacted by index, so a lane
that has stopped costs nothing and never changes again), which gives each
lane exactly the result of its own loop.  The engine's CUDA kernel
(``csrc/newton.cuh``) runs the same per lane with the same order of
operations: every dot summed from its first term on, the Newton step
through ``linsolve.solve_dense``.

Semantics per lane (``acme_tpu/ops/newton.py:106-219``): Newton to
max |res| < tol in at most ``maxiter`` iterations, bailing out (keeping z)
on a singular or non-finite Jacobian; on failure a bisection homotopy from
the warm-start origin toward the target, with the hopeless exit after 32
halvings that never left the origin and at most ``max_homotopy_steps``
steps; on convergence the origin moves to (p, z) with its sensitivity,
unless the Jacobian there is singular or non-finite.

Model matrices are (rows, cols) tensors shared by every lane, or
(L, rows, cols) with one matrix per lane (``make_subsystem_solver_mats``:
lanes sweeping component values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import xp as txp
from .linsolve import solve_dense

__all__ = ["WarmStart", "SolveResult", "make_subsystem_solver",
           "make_subsystem_solver_mats", "mv"]


class WarmStart(NamedTuple):
    """Extrapolation origin: z(p) ~= z0 + dzdp @ (p - p0), per lane
    (ref solvers.jl:183-215)."""
    p: torch.Tensor      # (L, np)
    z: torch.Tensor      # (L, nn)
    dzdp: torch.Tensor   # (L, nn, np)


class SolveResult(NamedTuple):
    z: torch.Tensor          # (L, nn)
    converged: torch.Tensor  # (L,) bool
    warm: WarmStart
    iters: torch.Tensor      # (L,) int32, Newton iterations spent


def mv(M, v):
    """M v per lane, each sum from its first term on: M (m, n) shared or
    (L, m, n) per lane, v (L, n) -> (L, m); zeros when n is 0."""
    L, n = v.shape
    m = M.shape[-2]
    if n == 0:
        return torch.zeros((L, m), dtype=v.dtype, device=v.device)
    acc = M[..., :, 0] * v[:, 0, None]
    for j in range(1, n):
        acc = acc + M[..., :, j] * v[:, j, None]
    return acc


def _mm(A, B):
    """A B per lane, each sum from its first term on: A (L, a, c), B (c, b)
    shared or (L, c, b) per lane -> (L, a, b)."""
    L, a, c = A.shape
    b = B.shape[-1]
    if c == 0:
        return torch.zeros((L, a, b), dtype=A.dtype, device=A.device)
    acc = A[:, :, 0, None] * B[..., None, 0, :]
    for k in range(1, c):
        acc = acc + A[:, :, k, None] * B[..., None, k, :]
    return acc


def _take(m, idx, dims=2):
    """The lanes ``idx`` of a per-lane matrix (``dims`` = 2) or vector
    (1) with its leading lane axis; a shared one as it is."""
    return m[idx] if m.dim() > dims else m


def make_subsystem_solver(nl, fq, pexp, q0, *, tol=1e-10, maxiter=500,
                          homotopy=True, max_homotopy_steps=4096):
    """``solve(p (L, np), warm) -> SolveResult`` for one nonlinear
    subsystem with the frozen model matrices fq (nq, nn), pexp (nq, np),
    q0 (nq,) (tensors, shared by every lane)."""
    base = make_subsystem_solver_mats(
        nl, fq.shape[1], dtype=fq.dtype, tol=tol, maxiter=maxiter,
        homotopy=homotopy, max_homotopy_steps=max_homotopy_steps)

    def solve(p, warm: WarmStart) -> SolveResult:
        return base(p, warm, fq, pexp, q0)

    return solve


def make_subsystem_solver_mats(nl, nn, *, dtype=None, tol=1e-10,
                               maxiter=500, homotopy=True,
                               max_homotopy_steps=4096):
    """Like :func:`make_subsystem_solver`, the model matrices runtime
    arguments: ``solve(p, warm, fq, pexp, q0)``, each shared or per lane
    (a leading lane axis)."""
    if dtype is None:
        dtype = torch.float64

    def solve(p, warm, fq, pexp, q0):
        return _solve_impl(nl, nn, dtype, tol, maxiter, homotopy,
                           max_homotopy_steps, p, warm, fq, pexp, q0)

    return solve


def _solve_impl(nl, nn, dtype, tol, maxiter, homotopy, max_homotopy_steps,
                p_arg, warm_arg, fq, pexp, q0):
    dev = p_arg.device
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)

    def eval_rj(pfull, z, fq_):
        """res (L, nn), J = Jq Fq (L, nn, nn), Jq (L, nn, nq) at
        q = pfull + Fq z."""
        q = pfull + mv(fq_, z)
        with torch.device(dev):
            res, Jq = nl(txp, q.T)
        res = res.T.reshape(q.shape[0], nn)
        Jq = Jq.permute(2, 0, 1).reshape(q.shape[0], nn, q.shape[1])
        return res, _mm(Jq, fq_), Jq

    def newton(pfull, z0, fq_):
        """Newton from z0 on every lane given: (z, conv, iterations)."""
        L = z0.shape[0]
        z = z0.clone()
        it = torch.zeros((L,), dtype=torch.int32, device=dev)
        conv = torch.zeros((L,), dtype=torch.bool, device=dev)
        if nn == 0:
            return z, torch.ones_like(conv), it
        live = torch.arange(L, device=dev)
        while live.numel():
            zl = z[live]
            res, J, _ = eval_rj(pfull[live], zl, _take(fq_, live))
            resmax = res.abs().amax(dim=1)
            finite = torch.isfinite(resmax) & torch.isfinite(J).all(
                dim=(1, 2))
            c = resmax < tol_t
            dz, ok = solve_dense(J, res[:, :, None])
            bail = ~finite | ~ok
            step = ~c & ~bail
            z[live] = torch.where(step[:, None], zl - dz[:, :, 0], zl)
            it[live] += 1
            conv[live] = c
            live = live[~(c | bail | (it[live] >= maxiter))]
        return z, conv, it

    def dzdp_at(pfull, z, fq_, pexp_):
        """(-J^-1 Jp, ok): ok False where the Jacobian at the solution is
        singular or non-finite (the caller keeps the old origin there)."""
        _, J, Jq = eval_rj(pfull, z, fq_)
        d, ok = solve_dense(J, _mm(Jq, pexp_))
        ok = ok & torch.isfinite(d).all(dim=(1, 2)) \
            & torch.isfinite(J).all(dim=(1, 2))
        return -d, ok

    def pfull_of(p, pexp_, q0_):
        return q0_ + mv(pexp_, p)

    p, warm = p_arg, warm_arg
    z0 = warm.z + mv(warm.dzdp, p - warm.p)
    pfull = pfull_of(p, pexp, q0)
    z, conv, iters = newton(pfull, z0, fq)
    fb = WarmStart(p=warm.p.clone(), z=warm.z.clone(),
                   dzdp=warm.dzdp.clone())

    if homotopy and not bool(conv.all()):
        eng = torch.nonzero(~conv).flatten()
        fq_e, pexp_e = _take(fq, eng), _take(pexp, eng)
        q0_e = _take(q0, eng, 1)
        start_p, tgt = warm.p[eng], p[eng]
        n_e = eng.numel()
        a = torch.full((n_e,), 0.5, dtype=dtype, device=dev)
        best = torch.zeros((n_e,), dtype=dtype, device=dev)
        hw = WarmStart(p=fb.p[eng], z=fb.z[eng], dzdp=fb.dzdp[eng])
        hz, hc = z[eng], conv[eng]
        steps = torch.zeros((n_e,), dtype=torch.int32, device=dev)
        hit = iters[eng]
        one = torch.ones((), dtype=dtype, device=dev)
        live = torch.arange(n_e, device=dev)
        while live.numel():
            al, bl = a[live], best[live]
            fq_l, pexp_l = _take(fq_e, live), _take(pexp_e, live)
            pa = (1.0 - al)[:, None] * start_p[live] + al[:, None] * tgt[live]
            wp, wz, wd = hw.p[live], hw.z[live], hw.dzdp[live]
            z0a = wz + mv(wd, pa - wp)
            pfa = pfull_of(pa, pexp_l, _take(q0_e, live, 1))
            zz, cc, its = newton(pfa, z0a, fq_l)
            dz_a, ok_a = dzdp_at(pfa, zz, fq_l, pexp_l)
            good = cc & ok_a
            hw.p[live] = torch.where(good[:, None], pa, wp)
            hw.z[live] = torch.where(good[:, None], zz, wz)
            hw.dzdp[live] = torch.where(good[:, None, None], dz_a, wd)
            best_new = torch.where(cc, al, bl)
            new_a = torch.where(cc, one, (al + bl) / 2.0)
            stuck = ~cc & ~((bl < new_a) & (new_a < al))
            steps[live] += 1
            st = steps[live]
            hopeless = (best_new <= 0.0) & (st >= 32)
            done = (best_new >= 1.0) | stuck | hopeless \
                | (st >= max_homotopy_steps)
            a[live], best[live] = new_a, best_new
            hz[live], hc[live] = zz, cc
            hit[live] += its
            live = live[~done]
        z[eng], conv[eng], iters[eng] = hz, hc, hit
        fb.p[eng], fb.z[eng], fb.dzdp[eng] = hw.p, hw.z, hw.dzdp

    # on convergence the origin moves to (p, z) (ref solvers.jl:231-234),
    # unless the Jacobian there is singular / non-finite
    dz_f, ok_f = dzdp_at(pfull, z, fq, pexp)
    upd = conv & ok_f
    warm_out = WarmStart(
        p=torch.where(upd[:, None], p, fb.p),
        z=torch.where(upd[:, None], z, fb.z),
        dzdp=torch.where(upd[:, None, None], dz_f, fb.dzdp))
    return SolveResult(z=z, converged=conv, warm=warm_out, iters=iters)
