"""Per-lane models on the CPU: a list of same-topology models in one
``FusedRunner``, the port's plain version against the JAX package.

``FusedRunner([m0, m1, ...])`` runs lane i on ``models[i % len(models)]``.
Every prepared coefficient that differs between the models is a ``_Var``:
an index into two per-lane float32 tables (hi, lo) that the kernel takes
as arguments; equal coefficients stay literals.  Only matrix coefficients
may differ: dimensions and decomposition must match, and the element
physics is ``models[0]``'s.

Two lists: the diode clipper with four values of its series resistor (the
construction of tests/test_fused.py's per-lane-model case, 2 varying
coefficients) and three fixed-pot Super Overs of the presets sweep (62).
Bounds: y within -90 dB of each lane's peak of the JAX interpret kernel
with fails and floored equal (two float32 implementations, as in
tests/test_torch_fused.py); -100 dB of each lane's peak against a float64
host run of the lane's own model (the JAX package's bound for its
full-accuracy configurations); tables, ``P``, initial state and per-lane
tolerances equal element for element.
"""

import copy

import numpy as np
import pytest

import acme_tpu as A
import acme_tpu_torch as T
from acme_tpu import models as M
from acme_tpu.ops.fused import FusedRunner as JaxRunner
from acme_tpu.ops.fused import _Var as JaxVar
from acme_tpu_torch import FusedRunner, runtime
from acme_tpu_torch import models as TM
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.convert import (coef_from_jax, coef_to_jax,
                                    state_to_jax)
from acme_tpu_torch.ops.emit import model_header
from acme_tpu_torch.ops.fused import _Var

PROD = S.PRODUCTION
FS = 44100
R1 = (820.0, 1000.0, 1500.0, 4700.0)
PRESETS = [S.PRESETS[i] for i in (0, 5, 7)]


def sine(amp, n):
    return (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(n)))[None, :]


def lane_db(y, ref):
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(y - ref).reshape(len(y), -1).max(1)
    peak = np.maximum(np.abs(ref).reshape(len(ref), -1).max(1), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def clipper_with_r1(pkg, circuit, r):
    """The diode clipper with another series resistor, by either
    package's compiler."""
    circ = circuit()
    circ.delete("r1")
    circ.add("r1", pkg.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return pkg.DiscreteModel(circ, 1 / FS)


def jax_clippers():
    return [clipper_with_r1(A, M.diodeclipper, r) for r in R1]


def port_clippers():
    return [clipper_with_r1(T, TM.diodeclipper, r) for r in R1]


@pytest.fixture(scope="module")
def presets():
    """(JAX runner, port runner, the port's models) for three presets of
    the Super Over, each package's models built by its own compiler
    (about 9 s a model)."""
    jm = [M.superover_model(**S.preset_spec(d, t)) for d, t in PRESETS]
    tm = S.build_models([S.preset_spec(d, t) for d, t in PRESETS], workers=1)
    kw = dict(lane_scale_idx=(0,), powerup="safe", powerup_samples=32)
    jr = JaxRunner(jm, interpret=True, compile_cache=False, **PROD, **kw)
    tr = FusedRunner([copy.deepcopy(m) for m in tm], **PROD, **kw,
                     device="cpu")
    return jr, tr, tm


def same_pattern(pj, pt):
    """Two merged coefficient structures agree: equal floats, and a _Var
    with the same index wherever either has one."""
    if isinstance(pj, (list, tuple)):
        assert len(pj) == len(pt)
        for a, b in zip(pj, pt):
            same_pattern(a, b)
    elif isinstance(pj, dict):
        assert sorted(pj) == sorted(pt)
        for k in pj:
            same_pattern(pj[k], pt[k])
    elif isinstance(pj, JaxVar) or isinstance(pt, _Var):
        assert isinstance(pj, JaxVar) and isinstance(pt, _Var)
        assert pj.i == pt.i
    else:
        assert pj == pt


def check_prepared_equal(jr, tr, L=128):
    """nvar, P, the tables, the initial state and the per-lane tolerances
    of a multi-model runner, element for element."""
    assert tr.nvar == jr.nvar and tr.nvar > 0
    same_pattern(jr.P, tr.P)
    np.testing.assert_array_equal(jr.var_tab, tr.var_tab)
    assert jr.tols == tr.tols and jr.gates == tr.gates
    assert jr.sub_cond_eq == tr.sub_cond_eq
    assert jr.sub_fragile == tr.sub_fragile
    jh, jl = jr._coef_tables(L // 128)
    th, tl = tr._coef_tables(L)
    assert tuple(th.shape) == (tr.nvar, L) == tuple(tl.shape)
    fh, fl = coef_from_jax(jh, jl, device="cpu")
    np.testing.assert_array_equal(fh.numpy(), th.numpy())
    np.testing.assert_array_equal(fl.numpy(), tl.numpy())
    bh, bl = coef_to_jax(th, tl)
    np.testing.assert_array_equal(bh, np.asarray(jh))
    np.testing.assert_array_equal(bl, np.asarray(jl))
    # lane l holds the values of models[l % K], hi + lo to float64's 48 bits
    K = len(tr.models)
    full = th.double().numpy() + tl.double().numpy()
    for l in (0, 1, K, L - 1):
        np.testing.assert_allclose(full[:, l], tr.var_tab[:, l % K],
                                   rtol=2.0 ** -47, atol=1e-45)
    js = jr.initial_state(L)
    ts = state_to_jax(tr.initial_state(L))
    for key, v in ts.items():
        np.testing.assert_array_equal(np.asarray(js[key]), v, err_msg=key)
    lv = np.linspace(0.1, 2.0, L)[:, None].astype(np.float32) \
        if tr.scale_idx else np.zeros((L, 0), np.float32)
    for floors in (None, np.random.default_rng(5).uniform(
            0, 1e-6, (L, max(tr.nsub, 1)))):
        jr._steady_floors = tr._steady_floors = floors
        jt, jg = jr._lane_tolerances(lv, L // 128)
        tt, tg = tr._lane_tolerances(lv, L)
        np.testing.assert_array_equal(jt.reshape(jt.shape[0], -1), tt)
        np.testing.assert_array_equal(jg.reshape(jg.shape[0], -1), tg)
    jr._steady_floors = tr._steady_floors = None


def test_clipper_list_matches_jax_interpret_and_float64_host():
    """Four clippers, 128 lanes x 200 samples of a 2 V sine, the production
    configuration on both sides: against the JAX interpret kernel (-90 dB,
    fails and floored equal) and, lane by lane, against the float64 host
    run of the lane's own model (-100 dB)."""
    n = 200
    u = sine(2.0, n)
    lv = np.zeros((128, 0))
    jr = JaxRunner(jax_clippers(), interpret=True, compile_cache=False,
                   time_chunk=104, **PROD)
    tr = FusedRunner(port_clippers(), **PROD, device="cpu")
    yj, _, ij = jr.run(u, lv, check=False)
    yt, _, it = tr.run(u, lv, check=False)
    assert tuple(yt.shape) == (128, 1, n)
    db = lane_db(yt.numpy(), np.asarray(yj))
    assert db.max() < -90.0, (db.max(), int(db.argmax()))
    np.testing.assert_array_equal(it.fails.numpy(), np.asarray(ij.fails))
    np.testing.assert_array_equal(it.floored.numpy(),
                                  np.asarray(ij.floored))
    assert int(it.fails.sum()) == 0
    y = yt.numpy()
    for i, r in enumerate(R1):
        yh = runtime.run(clipper_with_r1(T, TM.diodeclipper, r), u)
        for lane in (i, i + len(R1), 124 + i):
            db = lane_db(y[lane:lane + 1], yh[None])[0]
            assert db < -100.0, (r, lane, db)
    # distinct resistors give distinct outputs
    assert np.abs(y[0, 0] - y[3, 0]).max() > 1e-3


def test_clipper_list_prepared_equal():
    jr = JaxRunner(jax_clippers(), interpret=True, compile_cache=False,
                   **PROD)
    tr = FusedRunner(port_clippers(), **PROD, device="cpu")
    check_prepared_equal(jr, tr)


def test_superover_presets_prepared_equal(presets):
    jr, tr, _ = presets
    assert tr.nvar == 62
    assert tr.sub_fragile == [False, False, True]
    check_prepared_equal(jr, tr)
    # the sibling shares the prepared models and the tables
    pr = tr._powerup_runner()
    assert pr.P is tr.P and pr._prep is tr._prep
    assert pr._coef_tables(128)[0] is tr._coef_tables(128)[0]
    assert pr.plan.nvar == tr.plan.nvar == 62


def test_copies_of_one_model_are_the_single_model():
    """K copies of one model: no coefficient varies, the header (so its
    hash and the library) is the single model's byte for byte, and the
    output is bit-equal."""
    m = TM.diodeclipper_model()
    one = FusedRunner(copy.deepcopy(m), **PROD, device="cpu")
    many = FusedRunner([copy.deepcopy(m) for _ in range(3)], **PROD,
                       device="cpu")
    assert many.nvar == 0 and len(many.models) == 3
    assert many.P == one.P
    assert tuple(many._coef_tables(128)[0].shape) == (1, 128)
    assert model_header(many.plan) == model_header(one.plan)
    assert "NVAR = 0" in model_header(one.plan)
    u = sine(1.5, 64)
    y1, s1, i1 = one.run(u, np.zeros((128, 0)), check=False)
    y3, s3, i3 = many.run(u, np.zeros((128, 0)), check=False)
    np.testing.assert_array_equal(y1.numpy(), y3.numpy())
    for k in s1:
        np.testing.assert_array_equal(s1[k].numpy(), s3[k].numpy())
    np.testing.assert_array_equal(i1.iters.numpy(), i3.iters.numpy())


def test_varying_coefficients_are_table_reads_in_the_header():
    """The header of a list names NVAR and reads cv[i] / cvl[i]; the table
    VALUES are arguments, so another list with the same pattern of varying
    entries emits the same header."""
    a = FusedRunner(port_clippers(), **PROD, device="cpu")
    h = model_header(a.plan)
    assert f"NVAR = {a.nvar}" in h and "cv[0]" in h and "cvl[0]" in h
    assert h != model_header(FusedRunner(TM.diodeclipper_model(), **PROD,
                                         device="cpu").plan)


def test_lanes_match_single_model_runners():
    """Lane i of the multi-model runner against a single-model runner of
    ``models[i % K]`` (its own centering, the same balancing or not):
    -100 dB of the lane's peak."""
    u = sine(2.0, 128)
    lv = np.zeros((128, 0))
    y, _, info = FusedRunner(port_clippers(), **PROD, device="cpu").run(
        u, lv, check=False)
    assert int(info.fails.sum()) == 0
    y = y.numpy()
    for i, r in enumerate(R1):
        ys, _, _ = FusedRunner(clipper_with_r1(T, TM.diodeclipper, r),
                               **PROD, device="cpu").run(
            u, lv[:4], check=False)
        for lane in (i, 64 + i):
            db = lane_db(y[lane:lane + 1], ys.numpy()[:1])[0]
            assert db < -100.0, (r, lane, db)


def test_superover_presets_match_float64_host(presets):
    """Three presets x 43 levels, 128 lanes x 64 samples from cold across
    the handoff at sample 32 (both builds' configurations), against the
    port's float64 host runtime on a fresh copy of the lane's model driven
    by level x u.  Measured: worst -120.9 dB over the 24 lanes held;
    bound -100 dB of each lane's peak."""
    _, tr, models = presets
    n, L, K = 64, 128, len(PRESETS)
    levels = np.linspace(0.1, 2.0, 43)[np.arange(L) // K]
    u = sine(0.2, n)
    y, _, info = tr.run(u, levels[:, None], check=False)
    assert int(info.fails.sum()) == 0 and int(info.floored.sum()) == 0
    y = y.numpy()
    assert np.isfinite(y).all()
    rng = np.random.default_rng(1)
    held = sorted(set(range(6)) | set(range(L - 6, L))
                  | set(rng.choice(L, 12, replace=False).tolist()))
    for lane in held:
        yh = runtime.run(copy.deepcopy(models[lane % K]), levels[lane] * u)
        db = lane_db(y[lane:lane + 1], yh[None])[0]
        assert db < -100.0, (lane, db)
    # the presets differ audibly: same level, other pots
    assert np.abs(y[0, 0] - y[1, 0]).max() > 1e-3 * np.abs(y[0, 0]).max()


def test_models_of_different_dimensions_raise():
    with pytest.raises(ValueError, match="share dimensions"):
        FusedRunner([TM.diodeclipper_model(), TM.sallenkey_model()],
                    device="cpu")
    with pytest.raises(ValueError, match="share dimensions"):
        FusedRunner([TM.birdie_model(), TM.birdie_model(vol=0.5)],
                    device="cpu")


def test_build_models_pool_equals_serial():
    """``sweeps.build_models`` in worker processes (the exact part of each
    build) gives the models of a build in this process, bit for bit."""
    specs = [S.preset_spec(*S.PRESETS[0]), S.preset_spec(*S.PRESETS[7])]
    pooled = S.build_models(specs, workers=2)
    for spec, m in zip(specs, pooled):
        ref = TM.superover_model(**spec)
        for key in ("a", "b", "c", "x0", "dy", "ey", "fy", "y0"):
            np.testing.assert_array_equal(getattr(m, key), getattr(ref, key))
        for key in ("dqs", "eqs", "fqs", "fqprevs", "pexps", "q0s",
                    "init_zs"):
            for x, y in zip(getattr(m, key), getattr(ref, key)):
                np.testing.assert_array_equal(x, y, err_msg=key)
        u = sine(0.2, 32)
        np.testing.assert_array_equal(runtime.run(m, u),
                                      runtime.run(ref, u))


def test_presets_lane_grid():
    levels, drive, tone, lv, cfg = S.lane_grid("presets", 4096)
    n = len(S.PRESETS)
    assert n == 8 and cfg == dict(lane_scale_idx=(0,))
    assert lv.shape == (4096, 1) and (lv[:, 0] == levels).all()
    assert levels[0] == 0.1 and levels[-1] == 2.0
    assert (levels[:n] == levels[0]).all() and levels[n] > levels[0]
    for i in (0, 5, 8, 4095):
        assert (drive[i], tone[i]) == S.PRESETS[i % n]
    with pytest.raises(ValueError, match="multiple"):
        S.lane_grid("presets", 100)
