"""Lane groups on the CPU: ``fast_verify="group"`` with a fast path.

The JAX kernel decides its fast path's keep-or-redo once per grid block of
lanes (``jax.lax.cond(jnp.all(ok1), keep, redo)``,
``acme_tpu/ops/fused.py:2139-2146``): when any lane of the group fails the
keep test, every lane of the group takes the redo, so a passing lane's
result depends on its neighbours.  The port's plain version against the
JAX runner in interpret mode (as tests/test_fused.py runs it) on the diode
clipper:

* the partition of lanes into groups (``_group_S``), pair by pair;
* two groups of 1024 lanes (the shape of tests/test_fused.py's multi-group
  case) with the inputs of ``FAST`` and one fast step, whose input levels
  (from a seed) make keep tests fail in group 0 only; the same with the
  compensated pipeline in one group of 256 lanes; and ``polish_only``.
  Bound as tests/test_torch_configs.py holds every configuration: y within
  -90 dB of each lane's peak, fails and floored equal, each lane's Newton
  evaluations as there (``hold_effort``);

and on the port alone: the coupling itself (group mode equals merge bit
for bit in the group whose lanes all pass, and in the other group the
lanes that passed count the redo), ``group_lanes`` inert in every other
configuration, and L a multiple of 128.
"""

import copy

import numpy as np
import pytest
import torch

from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import models as TM
from acme_tpu_torch.sweeps import PRODUCTION as PROD
from test_torch_configs import hold_effort, lane_db

FS = 44100
T = 64
# tests/test_fused.py's FAST inputs with one fast step and one polish
# trip (so that both packages count each lane's own evaluations)
KW = dict(fast_iters=1, compensated=False, extrapolate=False,
          polish_iters=1)
# no fast step: the polish from the extrapolated start
POLISH_ONLY = dict(KW, fast_iters=0, polish_only=True, extrapolate=True)
LANES = (128, 256, 1024, 2048, 4096, 8192, 16384)


def sine(amp, n):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(n)))[None, :]


def levels(L, Lg, seed=0):
    """Per-lane input levels of a 1.5-amplitude sine: lanes of group 0 at
    0.01 to 3.0 (above about 0.33 one fast step misses the keep test on
    some samples, in the diodes' knee; below it never does), every other
    lane at 0.01 to 0.05."""
    rng = np.random.default_rng(seed)
    lv = rng.uniform(0.01, 0.05, L)
    lv[:Lg] = rng.uniform(0.01, 3.0, Lg)
    return lv[:, None]


# two groups of 1024 lanes, keep tests failing in group 0 only
TWO = levels(2048, 1024)


def port(kw, lv, n=T, **extra):
    """The port's plain version of the clipper at input levels ``lv``,
    from cold; returns (runner, y, state, info)."""
    fr = FusedRunner(TM.diodeclipper_model(), lane_scale_idx=(0,),
                     device="cpu", **kw, **extra)
    y, st, info = fr.run(sine(1.5, n), lv, check=False)
    return fr, y, st, info


@pytest.fixture(scope="module")
def partitions():
    """A runner of each package per ``group_lanes`` request."""
    out = {}
    for g in LANES:
        jr = JaxRunner(M.diodeclipper_model(), interpret=True,
                       compile_cache=False, group_lanes=g)
        tr = FusedRunner(TM.diodeclipper_model(), device="cpu",
                         group_lanes=g)
        out[g] = (jr, tr)
    return out


@pytest.mark.parametrize("group_lanes", LANES)
@pytest.mark.parametrize("L", LANES)
def test_partition_is_the_jax_runners(partitions, L, group_lanes):
    """Exactly the JAX runner's groups (its Mosaic caps define which lanes
    share a redo): e.g. 512 requested at 4096 lanes gives 1024, 128 at
    256 lanes the whole run."""
    jr, tr = partitions[group_lanes]
    S = L // 128
    assert tr._group_S(S) == jr._group_S(S)
    assert tr.group_size(L) == 128 * jr._group_S(S)
    assert L % tr.group_size(L) == 0
    if (L, group_lanes) == (4096, 512):
        assert tr.group_size(L) == 1024
    if (L, group_lanes) == (256, 128):
        assert tr.group_size(L) == 256


def against_jax(kw, lv, group_lanes, n=T):
    """The clipper from cold in both packages under ``kw`` and
    ``group_lanes``; holds y, fails, floored and the effort; returns the
    port's runner and outputs, and the JAX kernel's iters."""
    jr = JaxRunner(M.diodeclipper_model(), lane_scale_idx=(0,),
                   interpret=True, compile_cache=False, time_chunk=n,
                   group_lanes=group_lanes, **kw)
    fr, yt, st, it = port(kw, lv, n, group_lanes=group_lanes)
    L = len(lv)
    assert fr.plan.verify_group and fr.group_size(L) == \
        128 * jr._group_S(L // 128)
    yj, _, ij = jr.run(sine(1.5, n), lv, check=False)
    db = lane_db(yt.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
    hold_effort(jr, fr, ij, it)
    return fr, yt, st, it, np.asarray(ij.iters)


def merge_twin(kw, lv, n=T):
    return port(dict(kw, fast_verify="merge"), lv, n)


@pytest.mark.parametrize("case", ["fast_step", "polish_only"])
def test_two_groups_match_jax_interpret(case):
    """Two groups of 1024 lanes; the redo reaches the whole of group 0.
    The JAX kernel's evaluations show it too: its passing lanes in group 0
    count more than in the port's merge twin, and group 1 counts alike."""
    kw = KW if case == "fast_step" else POLISH_ONLY
    fr, yt, st, it, ij = against_jax(kw, TWO, 1024)
    assert fr.group_size(2048) == 1024
    _, _, _, im = merge_twin(kw, TWO)
    clean = passed_every_sample(fr, im.iters.numpy())
    assert clean[:1024].any() and not clean[:1024].all()
    assert clean[1024:].all()
    # the redo's evaluations on lanes that passed every keep test, in both
    # packages; none in group 1
    per_run = (fr.plan.fast + 1) * T
    assert (ij[:1024][clean[:1024]] > per_run).all()
    assert (it.iters.numpy()[:1024][clean[:1024]] > per_run).all()
    assert (ij[1024:] == per_run).all()


def test_one_compensated_group_matches_jax_interpret():
    """The compensated pipeline (df polish, extrapolated start) with one
    fast step, in one group of 256 lanes (the default request of 2048
    lanes is the whole run here)."""
    kw = dict(fast_iters=1, polish_iters=1)
    lv = levels(256, 256)
    fr, yt, st, it, ij = against_jax(kw, lv, 2048)
    assert fr.group_size(256) == 256
    _, _, _, im = merge_twin(kw, lv)
    # some keep test failed, so every lane took the redo on that sample
    assert (it.iters > im.iters).any()


def passed_every_sample(fr, iters):
    """The lanes of a merge run whose keep test passed on every sample:
    one fast step and one polish trip a sample, nothing redone."""
    return (iters == (fr.plan.fast + 1) * T).all(axis=1)


@pytest.mark.parametrize("case", ["fast_step", "polish_only"])
def test_coupling_on_the_port(case):
    """Group mode against its merge twin on the port alone, two groups of
    1024: bit for bit in y, state, fails, floored and iters in group 1,
    whose lanes all pass every keep test; in group 0 the lanes that passed
    every keep test count the redo's evaluations on top of merge's (their
    z moves only where the redo's gated Newton leaves the point that their
    polish accepted; on this circuit it lands on the same float32 point)."""
    kw = KW if case == "fast_step" else POLISH_ONLY
    fr, yg, sg, ig = port(kw, TWO, group_lanes=1024)
    _, ym, sm, im = merge_twin(kw, TWO)
    g1 = slice(1024, 2048)
    assert torch.equal(yg[g1], ym[g1])
    for k in sg:
        assert torch.equal(sg[k][:, g1], sm[k][:, g1]), k
    for a, b in ((ig.iters, im.iters), (ig.fails, im.fails),
                 (ig.floored, im.floored)):
        assert torch.equal(a[g1], b[g1])
    clean = passed_every_sample(fr, im.iters.numpy())
    assert clean[1024:].all() and clean[:1024].any()
    moved = (ig.iters[:1024] != im.iters[:1024]).any(1).numpy()
    assert moved[clean[:1024]].all()


@pytest.mark.parametrize("kw", [
    dict(KW, fast_verify="merge"), dict(KW, fast_verify="always"),
    dict(PROD, fast_iters=0, fast_verify="group"), {}],
    ids=["merge", "always", "fast_iters_0", "jax_defaults"])
def test_group_lanes_is_inert_elsewhere(kw):
    """Without the group redo the request changes nothing: the same y,
    state, fails, floored and iters, bit for bit, and the same build."""
    runs = [port(kw, TWO, n=32, group_lanes=g) for g in (128, 1024, 4096)]
    (f0, y0, s0, i0), rest = runs[0], runs[1:]
    assert not f0.plan.verify_group
    for fr, y, st, info in rest:
        assert fr.plan.kernel_name == f0.plan.kernel_name
        assert torch.equal(y, y0)
        for k in st:
            assert torch.equal(st[k], s0[k]), k
        for a, b in zip(info, i0):
            # tiers: None while tracing is off
            assert (a is None and b is None) or torch.equal(a, b)


def test_lanes_must_fill_blocks_in_group_mode():
    """In group mode L is a multiple of 128 (the JAX runner's ValueError),
    checked before any step runs, also when only the power-up sibling
    couples lane groups; every other configuration takes any L."""
    m = TM.diodeclipper_model()
    lv = np.linspace(0.1, 1.0, 100)[:, None]
    for kw in (dict(KW), POLISH_ONLY,
               dict(KW, fast_verify="merge", powerup=dict(
                   fast_verify="group"))):
        fr = FusedRunner(copy.deepcopy(m), lane_scale_idx=(0,),
                         device="cpu", **kw)
        with pytest.raises(ValueError, match="multiple of 128"):
            fr.run(sine(1.0, 8), lv)
    fr = FusedRunner(copy.deepcopy(m), lane_scale_idx=(0,), device="cpu",
                     **dict(KW, fast_verify="merge"))
    y, _, _ = fr.run(sine(1.0, 8), lv)
    assert y.shape == (100, 1, 8)
