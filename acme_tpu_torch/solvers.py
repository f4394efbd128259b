"""Host-side nonlinear solver stack (numpy, float64).

The port's own copy of ``acme_tpu/solvers.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

This is the cold-path / reference-semantics solver family mirroring
ACME.jl/src/solvers.jl: used at model-build time (initial operating
point, steady state) and by the host runtime that serves as the golden
reference for the device runtimes.  The device hot path re-expresses
Newton + homotopy as per-lane loops in the fused kernel (ops.fused).

Semantics preserved from the reference:
  * Newton with residual max-abs tolerance 1e-10, max 500 iterations
    (solvers.jl:175,207), warm-started by first-order extrapolation from the
    last converged solution's saved factorization (solvers.jl:209-215).
  * Singular Jacobian or non-finite residual aborts, returning current z
    (solvers.jl:220-225).
  * Homotopy wrapper with bisection continuation between the extrapolation
    origin and the target p (solvers.jl:268-296).
  * Caching wrapper with k-d tree nearest-neighbour warm starts
    (solvers.jl:304-405).
"""

from __future__ import annotations

import numpy as np

from .kdtree import KDTree

__all__ = ["ParametricNonLinEq", "LinearSolver", "SimpleSolver",
           "HomotopySolver", "CachingSolver", "linearize_solver"]


class ParametricNonLinEq:
    """Holds the residual/Jacobian closure triple and evaluation buffers
    (ref solvers.jl:6-36).

    ``func(res, J, scratch, z)`` fills res/J at z; ``set_p(scratch, p)``
    installs the parameter; ``calc_Jp(scratch, Jp)`` fills dres/dp.
    """

    def __init__(self, func, set_p=None, calc_Jp=None, scratch=None,
                 nn=None, np_=None):
        if set_p is None:
            set_p = _default_set_p
        if calc_Jp is None:
            calc_Jp = _default_calc_Jp
        if scratch is None:
            scratch = (np.zeros(np_), np.zeros((nn, np_)))
        self.func = func
        self.set_p = set_p
        self.calc_Jp = calc_Jp
        self.res = np.zeros(nn)
        self.Jp = np.zeros((nn, np_))
        self.J = np.zeros((nn, nn))
        self.scratch = scratch

    @property
    def nn(self):
        return self.res.shape[0]

    @property
    def np(self):
        return self.Jp.shape[1]

    def set_p_(self, p):
        self.set_p(self.scratch, p)

    def calc_Jp_(self):
        self.calc_Jp(self.scratch, self.Jp)

    def evaluate(self, z):
        self.func(self.res, self.J, self.scratch, z)


def _default_set_p(scratch, p):
    scratch[0][:] = p


def _default_calc_Jp(scratch, Jp):
    Jp[:] = scratch[1]


class LinearSolver:
    """Dense partial-pivot LU storing inverses on the diagonal
    (ref solvers.jl:38-137).  Sizes here are tiny (nn <= ~14), where this
    beats LAPACK dispatch; it also gives us the reference's exact
    singularity semantics (returns False instead of raising)."""

    def __init__(self, n: int):
        self.factors = np.zeros((n, n))
        self.ipiv = np.zeros(n, dtype=int)

    def setlhs(self, A: np.ndarray) -> bool:
        n = self.factors.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"matrix has size {A.shape}, needs {(n, n)}")
        f = self.factors
        f[:] = A
        for k in range(n):
            kp = k + int(np.argmax(np.abs(f[k:, k])))
            self.ipiv[k] = kp
            if f[kp, k] == 0.0:
                return False
            if kp != k:
                f[[k, kp], :] = f[[kp, k], :]
            inv = 1.0 / f[k, k]
            f[k, k] = inv
            f[k + 1:, k] *= inv
            f[k + 1:, k + 1:] -= np.outer(f[k + 1:, k], f[k, k + 1:])
        return True

    def solve(self, x: np.ndarray, b: np.ndarray):
        n = self.factors.shape[0]
        if x.shape != (n,) or b.shape != (n,):
            raise ValueError("dimension mismatch")
        if x is not b:
            x[:] = b
        for i in range(n):
            kp = self.ipiv[i]
            if kp != i:
                x[i], x[kp] = x[kp], x[i]
        for j in range(n):
            x[j + 1:] -= self.factors[j + 1:, j] * x[j]
        for j in range(n - 1, -1, -1):
            x[j] *= self.factors[j, j]
            x[:j] -= self.factors[:j, j] * x[j]

    def copy_from(self, other: "LinearSolver"):
        self.factors[:] = other.factors
        self.ipiv[:] = other.ipiv


class SimpleSolver:
    """Newton iteration with extrapolated warm start (ref solvers.jl:141-236)."""

    def __init__(self, nleq: ParametricNonLinEq, initial_p, initial_z):
        self.nleq = nleq
        nn, np_ = nleq.nn, nleq.np
        self.z = np.zeros(nn)
        self.linsolver = LinearSolver(nn)
        self.last_z = np.zeros(nn)
        self.last_p = np.zeros(np_)
        self.last_Jp = np.zeros((nn, np_))
        self.last_linsolver = LinearSolver(nn)
        self.iters = 0
        self.resmaxabs = 0.0
        self.tol = 1e-10
        self.set_extrapolation_origin(np.asarray(initial_p, float),
                                      np.asarray(initial_z, float))

    def set_resabstol(self, tol):
        self.tol = tol

    def set_extrapolation_origin(self, p, z, Jp=None, linsolver=None):
        if Jp is None:
            self.nleq.set_p_(p)
            self.nleq.evaluate(z)
            self.linsolver.setlhs(self.nleq.J)
            self.nleq.calc_Jp_()
            Jp, linsolver = self.nleq.Jp, self.linsolver
        self.last_linsolver.copy_from(linsolver)
        self.last_Jp[:] = Jp
        self.last_p[:] = p
        self.last_z[:] = z

    def get_extrapolation_origin(self):
        return self.last_p, self.last_z

    def get_extrapolation_jacobian(self):
        return -np.linalg.solve(self.nleq.J, self.nleq.Jp) \
            if self.nleq.nn > 0 else np.zeros((0, self.nleq.np))

    def hasconverged(self):
        return self.resmaxabs < self.tol

    def needediterations(self):
        return self.iters

    def solve(self, p, maxiter=500):
        # overflow/invalid during overshooting Newton steps is expected and
        # handled by the isfinite bail-out below, exactly as in the reference
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            return self._solve(p, maxiter)

    def _solve(self, p, maxiter=500):
        nleq = self.nleq
        nleq.set_p_(p)
        dp = np.asarray(p, float) - self.last_p
        step = self.last_Jp @ dp
        self.last_linsolver.solve(step, step)
        self.z[:] = self.last_z - step
        self.iters = 0
        for it in range(1, maxiter + 1):
            self.iters = it
            nleq.evaluate(self.z)
            self.resmaxabs = float(np.max(np.abs(nleq.res))) if nleq.res.size else 0.0
            if not np.isfinite(self.resmaxabs) or not np.all(np.isfinite(nleq.J)):
                return self.z
            if not self.linsolver.setlhs(nleq.J):  # singular Jacobian
                return self.z
            if self.hasconverged():
                break
            tmp = nleq.res.copy()
            self.linsolver.solve(tmp, tmp)
            self.z -= tmp
        if self.hasconverged():
            nleq.calc_Jp_()
            self.set_extrapolation_origin(p, self.z, nleq.Jp, self.linsolver)
        return self.z


class HomotopySolver:
    """Bisection homotopy continuation around a base solver
    (ref solvers.jl:238-302)."""

    def __init__(self, nleq: ParametricNonLinEq, initial_p, initial_z,
                 base=SimpleSolver):
        self.basesolver = base(nleq, initial_p, initial_z)
        self.iters = 0

    def set_resabstol(self, tol):
        self.basesolver.set_resabstol(tol)

    def set_extrapolation_origin(self, p, z):
        self.basesolver.set_extrapolation_origin(p, z)

    def get_extrapolation_origin(self):
        return self.basesolver.get_extrapolation_origin()

    def get_extrapolation_jacobian(self):
        return self.basesolver.get_extrapolation_jacobian()

    def hasconverged(self):
        return self.basesolver.hasconverged()

    def needediterations(self):
        return self.iters

    def solve(self, p):
        p = np.asarray(p, float)
        z = self.basesolver.solve(p)
        self.iters = self.basesolver.needediterations()
        if not self.hasconverged():
            a = 0.5
            best_a = 0.0
            start_p = self.basesolver.get_extrapolation_origin()[0].copy()
            while best_a < 1.0:
                pa = (1.0 - a) * start_p + a * p
                z = self.basesolver.solve(pa)
                self.iters += self.basesolver.needediterations()
                if self.hasconverged():
                    best_a = a
                    a = 1.0
                else:
                    new_a = (a + best_a) / 2.0
                    if not (best_a < new_a < a):
                        break  # no representable value left between best_a and a
                    a = new_a
        return z


class CachingSolver:
    """k-d-tree solution cache around a base solver (ref solvers.jl:304-405).

    Stores (p, z) pairs whenever the base solver needed more than 5
    iterations, and warm-starts from the nearest cached p.  Tree rebuilds are
    amortized.  On the TPU path this is replaced by previous-sample
    extrapolation (see SURVEY.md section 7); it is kept here for host-runtime
    parity with the reference.
    """

    def __init__(self, nleq: ParametricNonLinEq, initial_p, initial_z,
                 base=SimpleSolver):
        self.basesolver = base(nleq, initial_p, initial_z)
        initial_p = np.asarray(initial_p, float)
        initial_z = np.asarray(initial_z, float)
        self.ps = initial_p.reshape(-1, 1).copy()
        self.zs = initial_z.reshape(-1, 1).copy()
        self.tree = KDTree(self.ps)
        self.num_ps = 1
        self.new_count = 0
        self.new_count_limit = 2

    def set_resabstol(self, tol):
        self.basesolver.set_resabstol(tol)

    def set_extrapolation_origin(self, p, z):
        self.basesolver.set_extrapolation_origin(p, z)

    def get_extrapolation_origin(self):
        return self.basesolver.get_extrapolation_origin()

    def get_extrapolation_jacobian(self):
        return self.basesolver.get_extrapolation_jacobian()

    def hasconverged(self):
        return self.basesolver.hasconverged()

    def needediterations(self):
        return self.basesolver.needediterations()

    def solve(self, p):
        p = np.asarray(p, float)
        origin_p = self.basesolver.get_extrapolation_origin()[0]
        best_diff = float(np.sum((p - origin_p) ** 2))
        idx = -1
        # linear scan over recently appended, not-yet-indexed points
        for i in range(self.num_ps - self.new_count, self.num_ps):
            diff = float(np.sum((self.ps[:, i] - p) ** 2))
            if diff < best_diff:
                best_diff = diff
                idx = i
        tidx = self.tree.nearest(p, best_dist=best_diff, best_idx=idx)
        if tidx >= 0:
            idx = tidx
        if idx >= 0:
            self.basesolver.set_extrapolation_origin(self.ps[:, idx], self.zs[:, idx])
        z = self.basesolver.solve(p)
        if self.basesolver.needediterations() > 5 and self.hasconverged():
            if self.num_ps == self.ps.shape[1]:
                self.ps = np.hstack([self.ps, np.zeros_like(self.ps)])
                self.zs = np.hstack([self.zs, np.zeros_like(self.zs)])
            self.ps[:, self.num_ps] = p
            self.zs[:, self.num_ps] = z
            self.num_ps += 1
            self.new_count += 1
        if self.new_count > 0:
            self.new_count_limit -= 1
        if self.new_count > self.new_count_limit:
            self.tree = KDTree(self.ps[:, :self.num_ps])
            self.new_count = 0
            # amortization uses the grown buffer width (~2x num_ps), matching
            # the reference's alteration counter (src/solvers.jl:387-394)
            self.new_count_limit = 2 * self.ps.shape[1]
        return z


def default_solver(nleq, initial_p, initial_z):
    """The reference's default solver chain
    ``HomotopySolver{CachingSolver{SimpleSolver}}`` (ref ACME.jl:150)."""
    return HomotopySolver(nleq, initial_p, initial_z,
                          base=lambda n, p, z: CachingSolver(n, p, z, base=SimpleSolver))


def homotopy_simple_solver(nleq, initial_p, initial_z):
    """``HomotopySolver{SimpleSolver}`` factory."""
    return HomotopySolver(nleq, initial_p, initial_z, base=SimpleSolver)


def linearize_solver(solver, p):
    """Solve at p and return (z, dz/dp) (ref solvers.jl:407-414)."""
    z = solver.solve(p)
    solver.set_extrapolation_origin(p, z)
    if not solver.hasconverged():
        raise ValueError(f"Cannot linearize because no solution found at p={p}")
    return z.copy(), solver.get_extrapolation_jacobian()
