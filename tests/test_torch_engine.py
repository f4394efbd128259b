"""The port's float64 scan engine against the JAX package's, on the CPU.

The same models (each package builds its own with its own compiler) and
the same inputs, made with numpy, go through ``acme_tpu.engine`` and
``acme_tpu_torch.engine`` (``device="cpu"``: the plain torch version of
the kernel's step).  Bounds: ``solve_dense`` with ``ok`` equal and X
within 1e-13 relative where ok; the engines' y within -160 dB of each
lane's peak (both float64; the exp of the two libraries may differ by an
ulp), ``converged`` equal and Newton iterations equal on at least 99.9 %
of lane-samples (the rest printed); the float32 engines within -100 dB;
steady seeds within 1e-12.  The float32 engines agree at -100 dB where
their default tolerance keeps them near float64 (see
``test_float32_engine_against_jax``).
"""

import copy
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import acme_tpu as A
from acme_tpu import models as JM
from acme_tpu.engine import compile_model as j_compile
from acme_tpu.engine import compile_models as j_compile_models
from acme_tpu.ops.linsolve import solve_dense as j_solve

import acme_tpu_torch as TT
from acme_tpu_torch import engine as E
from acme_tpu_torch import models as TM
from acme_tpu_torch.engine import compile_model, compile_models
from acme_tpu_torch.ops.linsolve import solve_dense

FS = 44100
T = 600


def _db(a, b):
    """Each lane's max |a - b| over the peak of b, in dB; (L, ny, T)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.ndim == 2:
        a, b = a[None], b[None]
    err = np.abs(a - b).max(axis=(1, 2))
    peak = np.maximum(np.abs(b).max(axis=(1, 2)), 1e-30)
    return 20 * np.log10(err / peak + 1e-300)


def _sine(n=T, f=1000.0):
    return np.sin(2 * np.pi * f / FS * np.arange(n))


def _hold(name, got, want, y_db=-160.0):
    """The port's (y, state, info) against JAX's."""
    y, _, info = got
    yj, _, ij = want
    d = _db(y.numpy(), np.asarray(yj))
    assert d.max() < y_db, (name, d)
    conv, conv_j = info.converged.numpy(), np.asarray(ij.converged)
    assert np.array_equal(conv, conv_j), name
    it, it_j = info.iters.numpy(), np.asarray(ij.iters)
    same = (it == it_j).all(axis=-1)
    if not same.all():
        print(f"{name}: iterations differ at (t, lane)",
              np.argwhere(~same)[:20].tolist())
    assert same.mean() >= 0.999, (name, same.mean())


# -- solve_dense ---------------------------------------------------------------

def _dense_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for n in (1, 2, 3, 5, 8):
        cases[f"random{n}"] = (rng.normal(size=(16, n, n)),
                               rng.normal(size=(16, n, 2)))
    z = np.zeros((2, 3, 3))
    cases["singular"] = (np.stack([z[0], np.array([[1.0, 2, 3], [2, 4, 6],
                                                    [1, 0, 1]])]),
                         np.ones((2, 3, 1)))
    cases["zero_pivot"] = (np.array([[[0.0, 1.0], [1.0, 0.0]],
                                     [[0.0, 2.0, 1.0], [0.0, 1.0, 3.0],
                                      [4.0, 1.0, 1.0]]][0:1]),
                           np.array([[[2.0], [3.0]]]))
    cases["zero_pivot3"] = (np.array([[[0.0, 2.0, 1.0], [0.0, 1.0, 3.0],
                                       [4.0, 1.0, 1.0]]]),
                            np.array([[[1.0], [2.0], [3.0]]]))
    ties = rng.normal(size=(8, 5, 5))
    ties[:, :, 0] = np.array([1.0, -1.0, 1.0, -1.0, 0.5])
    ties[:, 1, 2] = -ties[:, 2, 2]
    cases["ties"] = (ties, rng.normal(size=(8, 5, 1)))
    for bad in (np.nan, np.inf, -np.inf):
        for where in ((0, 0), (1, 2), (2, 1)):
            J = rng.normal(size=(1, 3, 3))
            J[0][where] = bad
            cases[f"J{bad}{where}"] = (J, rng.normal(size=(1, 3, 2)))
        J = rng.normal(size=(1, 3, 3))
        B = rng.normal(size=(1, 3, 2))
        B[0, 1, 0] = bad
        cases[f"B{bad}"] = (J, B)
    J = rng.normal(size=(1, 1, 1))
    J[0, 0, 0] = np.nan
    cases["n1_nan"] = (J, np.ones((1, 1, 1)))
    cases["n1_zero"] = (np.zeros((1, 1, 1)), np.ones((1, 1, 1)))
    return cases


DENSE = _dense_cases()


@pytest.mark.parametrize("case", sorted(DENSE))
def test_solve_dense_against_jax(case):
    J, B = DENSE[case]
    X, ok = solve_dense(torch.as_tensor(J), torch.as_tensor(B))
    for i in range(J.shape[0]):
        Xj, okj = j_solve(jnp.asarray(J[i]), jnp.asarray(B[i]))
        assert bool(ok[i]) == bool(okj), (case, i)
        if bool(okj):
            Xj = np.asarray(Xj)
            got = X[i].numpy()
            scale = np.maximum(np.abs(Xj), 1e-300)
            fin = np.isfinite(Xj)
            assert np.array_equal(fin, np.isfinite(got)), (case, i)
            assert (np.abs(got - Xj)[fin] / scale[fin]).max(initial=0) \
                <= 1e-13, (case, i)
        else:
            # garbage, but the same shape
            assert X[i].shape == Xj.shape


# -- the engines on the bundled examples ---------------------------------------

def test_clipper_against_jax():
    u = 1.5 * _sine()[None]
    got = compile_model(TM.diodeclipper_model(), device="cpu").run(u)
    want = j_compile(JM.diodeclipper_model()).run(u)
    assert tuple(got[0].shape) == (1, T)
    _hold("clipper", got, want)


@pytest.mark.parametrize("path", ["run", "run_sweep"])
def test_birdie_against_jax(path):
    vols = np.array([0.2, 0.55, 0.9])
    s = 0.5 * _sine()
    cm = compile_model(TM.birdie_model(), device="cpu")
    cj = j_compile(JM.birdie_model())
    if path == "run":
        u = np.stack([np.vstack([s, np.full(T, v)]) for v in vols])
        got, want = cm.run(u), cj.run(u)
    else:
        got = cm.run_sweep(s[None], vols[:, None], (1,))
        want = cj.run_sweep(s[None], vols[:, None], (1,))
    _hold(f"birdie {path}", got, want)


def test_sallenkey_against_jax():
    u = np.stack([a * _sine()[None] for a in (0.1, 1.0)])
    got = compile_model(TM.sallenkey_model(), device="cpu").run(u)
    want = j_compile(JM.sallenkey_model()).run(u)
    assert tuple(got[2].iters.shape) == (T, 2, 0)
    _hold("sallenkey", got, want)


def _nonconv_circuit(pkg):
    circ = pkg.Circuit()
    circ.add("d", pkg.diode())
    circ.add("src", pkg.currentsource())
    circ.connect(("src", "+"), ("d", "+"))
    circ.connect(("src", "-"), ("d", "-"))
    circ.add("probe", pkg.voltageprobe())
    circ.connect(("probe", "+"), ("d", "+"))
    circ.connect(("probe", "-"), ("d", "-"))
    return pkg.DiscreteModel(circ, 1)


def test_nonconvergence_semantics():
    """tests/test_engine.py's circuit (a diode driven backwards by a current
    source has no solution): converged forward, a warning backwards, each
    as the JAX engine; a non-finite output raises."""
    cm = compile_model(_nonconv_circuit(TT), device="cpu")
    y, _, info = cm.run(np.array([[1.0, 1.0]]))
    assert bool(info.converged.all())
    yj, _, ij = j_compile(_nonconv_circuit(A)).run(np.array([[1.0, 1.0]]))
    assert _db(y.numpy()[None], np.asarray(yj)[None]).max() < -160
    cm2 = compile_model(_nonconv_circuit(TT), device="cpu")
    with pytest.warns(UserWarning, match="Failed to converge"):
        y, _, info = cm2.run(np.array([[-1.0]]))
    assert not bool(info.converged.all())
    with pytest.warns(UserWarning, match="Failed to converge"):
        _, _, ij = j_compile(_nonconv_circuit(A)).run(np.array([[-1.0]]))
    assert np.array_equal(info.converged.numpy(), np.asarray(ij.converged))
    assert np.array_equal(info.iters.numpy(), np.asarray(ij.iters))
    cm3 = compile_model(_nonconv_circuit(TT), device="cpu")
    with pytest.raises(RuntimeError, match="non-finite"):
        cm3.run(np.array([[np.nan]]))


def test_state_carry_bitwise():
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    u = np.stack([a * _sine()[None] for a in (0.5, 2.0)])
    y1, st, _ = cm.run(u[:, :, :250])
    y2, st, _ = cm.run(u[:, :, 250:], state=st)
    y, st_w, _ = cm.run(u)
    assert torch.equal(torch.cat([y1, y2], dim=2), y)
    assert torch.equal(st["x"], st_w["x"])
    for w, ww in zip(st["warms"], st_w["warms"]):
        assert all(torch.equal(a, b) for a, b in zip(w, ww))


def test_lane_batching_matches_single():
    cm = compile_model(TM.birdie_model(), device="cpu")
    vols = np.linspace(0.2, 1.0, 4)
    s = _sine()
    ub = np.stack([np.vstack([s, np.full(T, v)]) for v in vols])
    yb, _, _ = cm.run(ub)
    for i in (0, 3):
        yi, _, _ = cm.run(ub[i])
        np.testing.assert_allclose(yb[i].numpy(), yi.numpy(), atol=1e-11)


def _clipper(pkg, models_mod, r):
    circ = models_mod.diodeclipper()
    circ.delete("r1")
    circ.add("r1", pkg.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return pkg.DiscreteModel(circ, 1 / 44100)


RS = (820.0, 1000.0, 1500.0, 4700.0)


def test_compile_models_against_jax():
    """tests/test_engine.py's four clippers, one per lane."""
    u = 2.0 * _sine(400)[None]
    bm = compile_models([_clipper(TT, TM, r) for r in RS], device="cpu")
    y, _, info = bm.run(u)
    assert tuple(y.shape) == (len(RS), 1, 400)
    yj, _, ij = j_compile_models([_clipper(A, JM, r) for r in RS]).run(u)
    _hold("four clippers", (y, None, info), (yj, None, ij))
    for i, r in enumerate(RS):
        yh = TT.run(_clipper(TT, TM, r), u)
        assert np.max(np.abs(y[i].numpy() - yh)) < 2e-7
    assert float((y[0] - y[-1]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="share dimensions"):
        compile_models([_clipper(TT, TM, 1e3), TM.birdie_model()],
                       device="cpu")


def _warm_arrays(state):
    out = [np.asarray(state["x"])]
    for w in state["warms"]:
        out += [np.asarray(w.p), np.asarray(w.z), np.asarray(w.dzdp)]
    return out


def _assert_seeds(got, want):
    for a, b in zip(_warm_arrays({"x": got["x"].numpy(), "warms": [
            type(w)(*(v.numpy() for v in w)) for w in got["warms"]]}),
            _warm_arrays(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(
            1.0, float(np.abs(b).max(initial=0))))


def test_steady_initial_state_birdie():
    vols = np.array([[0.3], [0.8]])
    got = compile_model(TM.birdie_model(), device="cpu") \
        .steady_initial_state(vols, (1,))
    want = j_compile(JM.birdie_model()).steady_initial_state(vols, (1,))
    _assert_seeds(got, want)


def test_steady_initial_state_pots():
    """Four lanes of the main path's drive x tone grid, the seeding
    tolerance of the JAX bench (1e-9)."""
    from acme_tpu_torch import sweeps as S
    _, _, _, lv, _ = S.lane_grid("pots", 4096)
    lanes = lv[[0, 1365, 3224, 4095]]
    spec = S.model_spec("pots", "chain")
    got = compile_model(S.build_model("pots", "chain"), tol=1e-9,
                        device="cpu").steady_initial_state(lanes, (1, 2))
    jm = JM.superover_model(drive=spec["drive"], tone=spec["tone"],
                            level=spec["level"], vb_source=True)
    want = j_compile(jm, tol=1e-9).steady_initial_state(lanes, (1, 2))
    _assert_seeds(got, want)


def test_float32_engine_against_jax():
    """The float32 engines (tol 5e-4) on the clipper: at a 0.3 drive within
    -100 dB of each other; at a 1.5 drive both drift far from the float64
    engine (0.46 V at their default tolerance, a loose one for the diodes'
    currents) and apart from each other, so there the port's float32
    engine is held to no more error against float64 than the JAX one's."""
    u = np.stack([a * _sine()[None] for a in (0.3, 1.5)])
    got = compile_model(TM.diodeclipper_model(), dtype=torch.float32,
                        device="cpu").run(u)
    assert got[0].dtype == torch.float32
    want = j_compile(JM.diodeclipper_model(), dtype=jnp.float32).run(u)
    d = _db(got[0].numpy(), np.asarray(want[0]))
    assert d[0] < -100, d
    ref = compile_model(TM.diodeclipper_model(), device="cpu").run(u)[0]
    err = np.abs(got[0].numpy()[1] - ref.numpy()[1]).max()
    err_j = np.abs(np.asarray(want[0])[1] - ref.numpy()[1]).max()
    assert err <= 1.25 * err_j, (err, err_j)
    assert np.array_equal(got[2].converged.numpy(),
                          np.asarray(want[2].converged))


def test_second_run_rebuilds_nothing(tmp_path):
    """Runs of one engine, and a second engine of the same circuit at
    another tolerance, share one build of the kernel's source (g++ here:
    the card's builds are keyed the same way)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    from acme_tpu_torch.ops import build as B
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    lib = B.load_engine_host(cm._header, str(tmp_path))
    n = len(B.LAST_BUILD)
    u = torch.as_tensor(1.5 * _sine(100)[None, None])
    src = E._Src(umap=((2, 0),), ul=u)
    st, out = cm.host_scan(lib, cm.initial_state(1), src, 100)
    cm2 = compile_model(TM.diodeclipper_model(), tol=1e-12, device="cpu")
    assert cm2._header == cm._header
    assert B.load_engine_host(cm2._header, str(tmp_path)) is lib
    cm.host_scan(lib, st, src, 100)
    assert len(B.LAST_BUILD) == n


def test_superover_chain_against_jax():
    """The chain Super Over (the main path's model) at the references'
    tolerance, 2 lanes x 64 samples from the port's steady seeds (handed to
    the JAX engine through ``convert.engine_state_to_jax``)."""
    from acme_tpu.ops.newton import WarmStart as JWarm

    from acme_tpu_torch import sweeps as S
    from acme_tpu_torch.convert import engine_state_to_jax
    spec = S.model_spec("pots", "chain")
    m = S.build_model("pots", "chain")
    lanes = np.array([[0.3, 0.6], [0.8, 0.2]])
    cm = compile_model(copy.deepcopy(m), tol=1e-12, device="cpu")
    seed = compile_model(copy.deepcopy(m), tol=1e-9, device="cpu") \
        .steady_initial_state(lanes, (1, 2))
    u = 0.2 * _sine(64)[None]
    got = cm.run_sweep(u, lanes, (1, 2), state=seed)
    assert bool(got[2].converged.all())
    jm = JM.superover_model(drive=spec["drive"], tone=spec["tone"],
                            level=spec["level"], vb_source=True)
    js = engine_state_to_jax(seed, JWarm)
    js = {"x": jnp.asarray(js["x"]),
          "warms": tuple(JWarm(*(jnp.asarray(v) for v in w))
                         for w in js["warms"])}
    want = j_compile(jm, tol=1e-12).run_sweep(u, lanes, (1, 2), state=js)
    _hold("chain Super Over", got, want)


def test_engine_defaults_and_the_card():
    """The JAX engine's defaults (float64 at tol 1e-10, float32 at 5e-4,
    500 Newton iterations, homotopy, warn) on the card by default: without
    a card the constructors raise rather than run on the CPU."""
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    assert (cm.dtype, cm.tol, cm.newton_maxiter, cm.homotopy, cm.warn) == \
        (torch.float64, 1e-10, 500, True, True)
    cm32 = compile_model(TM.diodeclipper_model(), dtype=torch.float32,
                         device="cpu")
    assert cm32.tol == 5e-4
    with pytest.raises(ValueError, match="dtype"):
        compile_model(TM.diodeclipper_model(), dtype=torch.float16,
                      device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        compile_model(TM.diodeclipper_model())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        compile_models([TM.diodeclipper_model()])
    from acme_tpu_torch.convert import engine_state_from_jax
    st = cm.initial_state(2)
    with pytest.raises((RuntimeError, AssertionError)):
        engine_state_from_jax({"x": st["x"].numpy(), "warms": [
            tuple(v.numpy() for v in w) for w in st["warms"]]})


def test_step_fn_chains_as_run():
    """``step_fn`` one sample at a time (u_t (L, nu)) equals ``run`` over
    the same samples, bit for bit; the iteration histogram is the JAX
    engine's."""
    cm = compile_model(TM.birdie_model(), device="cpu")
    s = 0.5 * _sine(40)
    u = np.stack([np.vstack([s, np.full(40, v)]) for v in (0.3, 0.8)])
    y, st, info = cm.run(u)
    step = cm.step_fn()
    carry = cm.initial_state(2)
    ys = []
    for t in range(40):
        carry, (yt, ct, it) = step(carry, u[:, :, t])
        ys.append(yt)
        assert torch.equal(ct, info.converged[t])
        assert torch.equal(it, info.iters[t])
    assert torch.equal(torch.stack(ys, dim=2), y)
    assert torch.equal(carry["x"], st["x"])
    _, _, ij = j_compile(JM.birdie_model()).run(u)
    edges, counts = info.iter_histogram()
    edges_j, counts_j = ij.iter_histogram()
    assert np.array_equal(edges, edges_j)
    assert np.array_equal(counts, counts_j)
