"""acme_tpu_torch.ops.dfmath against acme_tpu.ops.dfmath on seeded inputs.

Every op is built from +, -, *, / and comparisons on float32 in the same
order in both modules, so on the CPU the pairs must agree bit for bit.
The JAX side runs eagerly (op by op), as the JAX package's own dfmath
tests do.  One exception, and its bound: XLA's CPU backend flushes
float32 subnormals to zero and torch does not, so a component below
2**-126 in magnitude (an exp lo part at large negative arguments) is
compared after flushing both sides -- a difference below 1.2e-38.  And
``sqrt``: its lo part (the correction r / 2s) may differ in its last bit,
a relative difference below 2**-44 of the value, so sqrt is held to that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acme_tpu.ops import dfmath as jdf
from acme_tpu_torch.ops import dfmath as tdf

N = 512


def _pair(rng, scale, n=N):
    hi = (rng.standard_normal(n) * scale).astype(np.float32)
    lo = (hi.astype(np.float64) * rng.uniform(-2 ** -25, 2 ** -25, n)
          ).astype(np.float32)
    return hi, lo


def _both(hi, lo):
    return (jdf.DF(jnp.asarray(hi), jnp.asarray(lo)),
            tdf.DF(torch.from_numpy(hi), torch.from_numpy(lo)))


TINY = np.float32(2.0 ** -126)


def _ftz(a):
    a = np.array(a)
    if a.dtype == np.float32:
        a[np.abs(a) < TINY] = 0.0
    return a


def _eq(j, t):
    if isinstance(j, jdf.DF):
        np.testing.assert_array_equal(_ftz(j.hi), _ftz(t.hi.numpy()))
        np.testing.assert_array_equal(_ftz(j.lo), _ftz(t.lo.numpy()))
    else:
        np.testing.assert_array_equal(_ftz(j), _ftz(t.numpy()))


BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "radd_const": lambda a, b: 0.1 + a,
    "rsub_const": lambda a, b: 1.0 - a,
    "rmul_const": lambda a, b: 0.3 * a,
    "rdiv_const": lambda a, b: 2.0 / a,
    "lt": lambda a, b: a < b,
    "ge": lambda a, b: a >= b,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_bitwise(op):
    rng = np.random.default_rng(1)
    ja, ta = _both(*_pair(rng, 3.0))
    jb, tb = _both(*_pair(rng, 2.0))
    _eq(BINARY[op](ja, jb), BINARY[op](ta, tb))


def _unary_cases():
    return {
        "neg": (lambda m, a: -a, 3.0),
        "pow3": (lambda m, a: a ** 3, 2.0),
        "exp": (lambda m, a: m.exp(a), 20.0),
        "exp_wide": (lambda m, a: m.exp(a), 60.0),
        "expm1": (lambda m, a: m.expm1(a), 2.0),
        "expm1_small": (lambda m, a: m.expm1(a), 1e-3),
        "tanh": (lambda m, a: m.tanh(a), 2.0),
        "abs": (lambda m, a: m.abs(a), 1.0),
        "sign": (lambda m, a: m.sign(a), 1.0),
        "minimum": (lambda m, a: m.minimum(a, 0.25), 1.0),
        "maximum": (lambda m, a: m.maximum(a, -0.25), 1.0),
        "where": (lambda m, a: m.where(a > 0.0, a, m.full_like(a, 7.0)),
                  1.0),
        "ones_like": (lambda m, a: m.ones_like(a) * a, 1.0),
    }


@pytest.mark.parametrize("op", sorted(_unary_cases()))
def test_unary_ops_bitwise(op):
    fn, scale = _unary_cases()[op]
    rng = np.random.default_rng(2)
    ja, ta = _both(*_pair(rng, scale))
    _eq(fn(jdf, ja), fn(tdf, ta))


def test_sqrt_to_last_bit_of_lo():
    rng = np.random.default_rng(2)
    ja, ta = _both(*_pair(rng, 5.0))
    j = jdf.sqrt(jdf.abs(ja))
    t = tdf.sqrt(tdf.abs(ta))
    np.testing.assert_array_equal(np.asarray(j.hi), t.hi.numpy())
    jv = np.asarray(j.hi, np.float64) + np.asarray(j.lo, np.float64)
    tv = t.hi.double().numpy() + t.lo.double().numpy()
    assert np.all(np.abs(jv - tv) <= 2.0 ** -44 * np.abs(jv))


def test_isfinite_and_stack_bitwise():
    rng = np.random.default_rng(3)
    hi, lo = _pair(rng, 1.0, 8)
    hi[2] = np.inf
    lo[5] = np.nan
    ja, ta = _both(hi, lo)
    _eq(jdf.isfinite(ja), tdf.isfinite(ta))
    js = jdf.stack([ja, ja * 2.0])
    ts = tdf.stack([ta, ta * 2.0])
    _eq(js, ts)
    _eq(jdf.concatenate([js, js], axis=0), tdf.concatenate([ts, ts], axis=0))


def test_exp_matches_float64():
    """The df exp carries ~48 bits: relative error far below float32's."""
    rng = np.random.default_rng(4)
    hi, lo = _pair(rng, 20.0)
    e = tdf.exp(tdf.DF(torch.from_numpy(hi), torch.from_numpy(lo)))
    got = e.hi.double().numpy() + e.lo.double().numpy()
    ref = np.exp(hi.astype(np.float64) + lo.astype(np.float64))
    assert np.max(np.abs(got / ref - 1.0)) < 1e-12
