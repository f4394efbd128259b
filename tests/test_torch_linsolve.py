"""Per-lane tiny solves of the port against the JAX package's
``_solve_rows`` (acme_tpu/ops/fused.py), float32 and double-float, on
seeded well- and ill-conditioned systems of size 1 to 5.

The elimination is the same sequence of float32 operations in both, so
the results must agree bit for bit (the JAX side runs eagerly, op by op).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acme_tpu.ops import dfmath as jdf
from acme_tpu.ops.fused import _solve_rows as jax_solve_rows
from acme_tpu_torch.ops import dfmath as tdf
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
