"""Per-lane tiny solves of the port against the JAX package's
``_solve_rows`` (acme_tpu/ops/fused.py), float32 and double-float, on
seeded well- and ill-conditioned systems of size 1 to 5 and 7 (the
un-decomposed Super Over's, with its six right-hand columns).

The elimination is the same sequence of float32 operations in both, so
the results must agree bit for bit (the JAX side runs eagerly, op by op).
Beside them, the CUDA kernel's own elimination (``csrc/linsolve.cuh``,
compiled for the host with g++; skipped without it) against this plain
version on the systems where a decision is close: pivot ties, a zero
pivot, singular systems, NaN and inf inputs, unpivoted, and systems
whose pivot cascade trades rows at every elimination step.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acme_tpu.ops import dfmath as jdf
from acme_tpu.ops.fused import _solve_rows as jax_solve_rows
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.models import diodeclipper_model
from acme_tpu_torch.ops import dfmath as tdf
from acme_tpu_torch.ops.build import load_host
from acme_tpu_torch.ops.linsolve_tiny import solve_rows

LANES = 64


def systems(n, cond, m, seed):
    """(J (n, n, L), R (m, n, L)) float64 with equilibration-relevant
    row/column scales and condition number ~cond."""
    rng = np.random.default_rng(seed)
    J = np.empty((n, n, LANES))
    for lane in range(LANES):
        U, _ = np.linalg.qr(rng.normal(size=(n, n)))
        V, _ = np.linalg.qr(rng.normal(size=(n, n)))
        sv = np.logspace(0, -np.log10(cond), n)
        A = (U * sv) @ V.T
        rows = 10.0 ** rng.uniform(-6, 2, n)
        cols = 10.0 ** rng.uniform(-2, 2, n)
        J[:, :, lane] = rows[:, None] * A * cols[None, :]
    R = rng.normal(size=(m, n, LANES))
    return J, R


def _split(a):
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


CASES = [(n, cond, m, refine)
         for n in (1, 2, 3, 4, 5)
         for cond in (1e2, 1e7)
         for m, refine in ((1, 0), (3, 1))]
# the full path's 7x7, as its step runs it: a Newton step (1, 0), the df
# verdict (6, 0) and the float32 polish with its columns (6, 1)
CASES += [(7, cond, m, refine)
          for cond in (1e2, 1e7)
          for m, refine in ((1, 0), (6, 0), (6, 1))]


@pytest.mark.parametrize("n,cond,m,refine", CASES)
def test_solve_rows_f32_bitwise(n, cond, m, refine):
    J, R = systems(n, cond, m, seed=n * 10 + m)
    J32, R32 = J.astype(np.float32), R.astype(np.float32)
    Jj = [[jnp.asarray(J32[i, j]) for j in range(n)] for i in range(n)]
    Rj = [[jnp.asarray(R32[k, i]) for i in range(n)] for k in range(m)]
    Jt = [[torch.from_numpy(J32[i, j]) for j in range(n)] for i in range(n)]
    Rt = [[torch.from_numpy(R32[k, i]) for i in range(n)] for k in range(m)]
    Xj = jax_solve_rows(Jj, Rj, refine=refine, pivot=True)
    Xt = solve_rows(Jt, Rt, refine=refine, pivot=True)
    for k in range(m):
        for i in range(n):
            np.testing.assert_array_equal(np.asarray(Xj[k][i]),
                                          Xt[k][i].numpy())


@pytest.mark.parametrize("n,cond,m,refine",
                         [c for c in CASES if c[3] == 0])
def test_solve_rows_df_bitwise(n, cond, m, refine):
    J, R = systems(n, cond, m, seed=100 + n * 10 + m)
    Jh, Jl = _split(J)
    Rh, Rl = _split(R)
    Jj = [[jdf.DF(jnp.asarray(Jh[i, j]), jnp.asarray(Jl[i, j]))
           for j in range(n)] for i in range(n)]
    Rj = [[jdf.DF(jnp.asarray(Rh[k, i]), jnp.asarray(Rl[k, i]))
           for i in range(n)] for k in range(m)]
    Jt = [[tdf.DF(torch.from_numpy(Jh[i, j]), torch.from_numpy(Jl[i, j]))
           for j in range(n)] for i in range(n)]
    Rt = [[tdf.DF(torch.from_numpy(Rh[k, i]), torch.from_numpy(Rl[k, i]))
           for i in range(n)] for k in range(m)]
    Xj = jax_solve_rows(Jj, Rj, refine=0, pivot=True, xp=jdf)
    Xt = solve_rows(Jt, Rt, refine=0, pivot=True, xp=tdf)
    for k in range(m):
        for i in range(n):
            np.testing.assert_array_equal(np.asarray(Xj[k][i].hi),
                                          Xt[k][i].hi.numpy())
            np.testing.assert_array_equal(np.asarray(Xj[k][i].lo),
                                          Xt[k][i].lo.numpy())


@pytest.mark.parametrize("n", [2, 3, 5])
def test_df_solve_resolves_ill_conditioned(n):
    """At cond 1e7 the df elimination is good to ~cond * 1e-14."""
    J, R = systems(n, 1e7, 1, seed=7 + n)
    Jh, Jl = _split(J)
    Rh, Rl = _split(R)
    Jt = [[tdf.DF(torch.from_numpy(Jh[i, j]), torch.from_numpy(Jl[i, j]))
           for j in range(n)] for i in range(n)]
    Rt = [[tdf.DF(torch.from_numpy(Rh[0, i]), torch.from_numpy(Rl[0, i]))
           for i in range(n)]]
    X = solve_rows(Jt, Rt, refine=0, pivot=True, xp=tdf)[0]
    Jx = Jh.astype(np.float64) + Jl
    Rx = Rh.astype(np.float64) + Rl
    for lane in range(LANES):
        ref = np.linalg.solve(Jx[:, :, lane], Rx[0, :, lane])
        got = np.array([X[i].hi[lane].item() + X[i].lo[lane].item()
                        for i in range(n)])
        assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


# -- the kernel's elimination on the hard cases (csrc/linsolve.cuh) ----------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's sources compiled for the host (any model's build holds
    the solve entries)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    out = str(tmp_path_factory.mktemp("acme_build"))
    clip = FusedRunner(diodeclipper_model(), **S.PRODUCTION, device="cpu")
    return load_host(clip.plan, out)


# the sizes the host entry holds from 3 up (1 and 2 are closed forms): the
# main path's fragile 5x5 with 1 + 2 columns, the full path's 7x7 with
# 1 + 5
HARD_SIZES = [(3, 1), (4, 1), (5, 1), (3, 3), (4, 3), (5, 3), (7, 6)]
HARD_KINDS = ["ties", "zero_pivot", "nan", "unpivoted", "swaps"]


def hard_systems(kind, n, m, seed, count=LANES):
    """(J (count, n, n), R (count, m, n)) float64: small integers, so that
    pivot candidates tie and some systems are singular ("ties"); a zero
    leading pivot, a zero column in every eighth system ("zero_pivot");
    NaN and inf at random places of J and R ("nan"); seeded systems as
    ``systems`` makes them ("unpivoted", solved without pivoting); systems
    whose pivot cascade trades rows at every step ("swaps",
    ``swapping_systems``)."""
    if kind == "swaps":
        return swapping_systems(n, m, seed, count)
    rng = np.random.default_rng(seed)
    J, R = systems(n, 1e4, m, seed)
    J, R = np.moveaxis(J, 2, 0)[:count], np.moveaxis(R, 2, 0)[:count]
    if kind == "ties":
        J = rng.integers(-2, 3, size=J.shape).astype(float)
        R = rng.integers(-2, 3, size=R.shape).astype(float)
    elif kind == "zero_pivot":
        J[:, 0, 0] = 0.0
        J[::8, :, n - 1] = 0.0
    elif kind == "nan":
        for a in (J, R):
            hit = rng.random(a.shape) < 0.05
            a[hit] = rng.choice([np.nan, np.inf, -np.inf], hit.sum())
    return J, R


def cascade_trades(J, dtype):
    """Whether the elimination of ``J`` (n, n), equilibrated as
    ``solve_rows`` equilibrates it, trades rows at each step (n - 1
    booleans): the running pivot row trades places with each later row
    whose entry is larger, in ``dtype``."""
    A = np.array(J, dtype=dtype)
    rs = 1 / np.abs(A).max(axis=1)
    A = A * rs[:, None].astype(dtype)
    cs = 1 / np.abs(A).max(axis=0)
    A = A * cs[None, :].astype(dtype)
    n = len(A)
    traded = []
    for k in range(n - 1):
        best, best_abs, any_trade = A[k].copy(), abs(A[k, k]), False
        for i in range(k + 1, n):
            if abs(A[i, k]) > best_abs:
                best, A[i] = A[i].copy(), best
                any_trade = True
            best_abs = max(abs(A[i, k]), best_abs)
        A[k] = best
        A[k + 1:] -= np.outer(A[k + 1:, k] / A[k, k], A[k])
        traded.append(any_trade)
    return traded


def swapping_systems(n, m, seed, count=LANES):
    """(J (count, n, n), R (count, m, n)) float64 from a generator of
    their own: row-permuted P L U products (unit lower L with entries below
    1 in size) under random row and column scales, kept where the
    equilibrated elimination trades rows at every step in float32 and in
    float64 alike."""
    rng = np.random.default_rng([seed, 1])
    out = []
    while len(out) < count:
        L = np.tril(rng.uniform(-0.9, 0.9, (n, n)), -1) + np.eye(n)
        U = np.triu(rng.normal(size=(n, n)), 1) + np.diag(
            rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n))
        J = (L @ U)[rng.permutation(n)]
        J = 10.0 ** rng.uniform(-3, 1, n)[:, None] * J \
            * 10.0 ** rng.uniform(-1, 1, n)[None, :]
        if all(cascade_trades(J, np.float32)) and \
                all(cascade_trades(J, np.float64)):
            out.append(J)
    return np.stack(out), rng.normal(size=(count, m, n))


@pytest.mark.parametrize("n,m", HARD_SIZES)
@pytest.mark.parametrize("use_df", [0, 1])
def test_swaps_trade_at_every_step(use_df, n, m):
    """Every "swaps" system of the hard cases trades rows at every
    elimination step."""
    J, R = hard_systems("swaps", n, m, seed=100 * use_df + 10 * n + m)
    assert J.shape == (LANES, n, n) and R.shape == (LANES, m, n)
    for Ji in J:
        for dtype in (np.float32, np.float64):
            assert all(cascade_trades(Ji, dtype))


def assert_same_bits(a, b):
    """Every bit equal where a value is not NaN (signed zeros too), NaN at
    the same places: which NaN an x86 operation returns depends on its
    operands' order, which the compiler may choose; on the card every NaN
    is the canonical one."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    num = ~np.isnan(a)
    np.testing.assert_array_equal(a[num].view(np.uint32),
                                  b[num].view(np.uint32))


@pytest.mark.parametrize("kind", HARD_KINDS)
@pytest.mark.parametrize("n,m", HARD_SIZES)
@pytest.mark.parametrize("use_df", [0, 1])
def test_kernel_solve_hard_cases_bitwise(host_lib, use_df, n, m, kind):
    """The kernel's elimination (float32 with one refinement sweep, or df
    without, as the step runs them) against the plain ``solve_rows`` on
    the same systems: every bit of X equal (signed zeros included; NaN
    where NaN), through pivot ties, a zero pivot, singular systems, NaN
    and inf inputs, and without pivoting."""
    J, R = hard_systems(kind, n, m, seed=100 * use_df + 10 * n + m)
    pivot = kind != "unpivoted"
    refine = 1 - use_df
    with np.errstate(invalid="ignore"):
        Jh, Jl = _split(np.ascontiguousarray(J))
        Rh, Rl = _split(np.ascontiguousarray(R))
    Jl[~np.isfinite(Jh)] = 0.0
    Rl[~np.isfinite(Rh)] = 0.0
    count = J.shape[0]
    Xh = np.zeros((count, m, n), np.float32)
    Xl = np.zeros((count, m, n), np.float32)
    ptr = lambda a: a.ctypes.data
    with np.errstate(invalid="ignore"):
        assert host_lib.acme_solve_host(
            n, m, count, use_df, refine, int(pivot), ptr(Jh), ptr(Jl),
            ptr(Rh), ptr(Rl), ptr(Xh), ptr(Xl)) == 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if use_df:
        Jt = [[tdf.DF(t(Jh[:, i, j]), t(Jl[:, i, j])) for j in range(n)]
              for i in range(n)]
        Rt = [[tdf.DF(t(Rh[:, k, i]), t(Rl[:, k, i])) for i in range(n)]
              for k in range(m)]
        X = solve_rows(Jt, Rt, refine=0, pivot=pivot, xp=tdf)
        want_h = np.stack([[x.hi.numpy() for x in row] for row in X])
        want_l = np.stack([[x.lo.numpy() for x in row] for row in X])
        assert_same_bits(Xl, np.moveaxis(want_l, 2, 0))
    else:
        Jt = [[t(Jh[:, i, j]) for j in range(n)] for i in range(n)]
        Rt = [[t(Rh[:, k, i]) for i in range(n)] for k in range(m)]
        X = solve_rows(Jt, Rt, refine=refine, pivot=pivot)
        want_h = np.stack([[x.numpy() for x in row] for row in X])
    assert_same_bits(Xh, np.moveaxis(want_h, 2, 0))
    if kind in ("zero_pivot", "nan"):
        assert not np.isfinite(Xh).all()
