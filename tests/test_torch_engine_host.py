"""The scan engine's CUDA source compiled for the CPU and checked here.

``acme_tpu_torch/ops/csrc/scan.cu`` (with ``dense.cuh`` and
``newton.cuh``) is ``__host__ __device__`` code, so g++ compiles it
(``-std=c++17 -O2 -ffp-contract=off``, with the engine header that
``emit.engine_header`` writes) into a shared library whose host entry runs
the kernel's per-lane loop lane by lane.  Against the plain torch version
on the same inputs:

* ``solve_dense`` on random, singular, zero-pivot, tied-pivot and
  NaN / inf systems, and on systems that swap rows at every elimination
  step, float64 and float32: bit for bit (no transcendental is
  involved), NaN for NaN;
* the whole run on the clipper (float64 and float32), birdie with its
  volume pot as a lane input, four clippers as per-lane models, the chain
  Super Over from its steady seeds (4 lanes x 64 samples) and the
  nonconvergence circuit of tests/test_engine.py: y within -180 dB of
  each lane's peak (the host's libm exp and torch's differ by an ulp in
  some 5 % of arguments), ``converged`` equal;
* one model's block shared by every lane (lane stride 0) against the
  same model as per-lane blocks (``compile_models`` of copies): bit for
  bit; a lane count that is not a multiple of 32 (the card's last block
  ragged) against the plain scan, its first 32 lanes bit for bit as a
  32-lane run.

Skipped where g++ is absent.
"""

import copy
import shutil

import numpy as np
import pytest
import torch

import acme_tpu_torch as TT
from acme_tpu_torch import models as TM
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.engine import _Src, compile_model, compile_models
from acme_tpu_torch.ops.build import load_engine_host
from acme_tpu_torch.ops.linsolve import solve_dense

FS = 44100
KERNEL_DB = -180.0


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return str(tmp_path_factory.mktemp("acme_engine_build"))


def _sine(n, f=1000.0):
    return np.sin(2 * np.pi * f / FS * np.arange(n))


# -- solve_dense ---------------------------------------------------------------

def _hard_cases():
    rng = np.random.default_rng(11)
    out = []
    for n in (1, 2, 3, 5, 8):
        for m in (1, 2):
            J = rng.normal(size=(24, n, n))
            B = rng.normal(size=(24, n, m))
            J[1] = 0.0                                  # singular
            if n > 1:
                J[2, 0, :] = 0.0
                J[2, :, 0] = 0.0                        # zero column
                J[3, 0, 0] = 0.0                        # leading zero pivot
                J[4, :, 0] = np.where(np.arange(n) % 2, -1.0, 1.0)  # ties
                J[5, 1] = 2 * J[5, 0]                   # rank deficient
            J[6].flat[rng.integers(n * n)] = np.nan
            J[7].flat[rng.integers(n * n)] = np.inf
            J[8].flat[rng.integers(n * n)] = -np.inf
            B[9].flat[rng.integers(n * m)] = np.nan
            B[10].flat[rng.integers(n * m)] = np.inf
            J[11] = np.nan
            out.append((n, m, J, B))
    return out + _swapping_cases()


def _swapping_cases():
    """At every size the engine builds above 1 (2, 3, 5 and 8): 8
    systems each whose elimination swaps rows at every step."""
    rng = np.random.default_rng(12)
    return [(n, m, _swapping(rng, n, 8), rng.normal(size=(8, n, m)))
            for n in (2, 3, 5, 8) for m in (1, 2)]


def _pivots(J):
    """The pivot row that solve_dense's partial pivoting takes at each
    elimination step of J (float64, no NaN)."""
    A = np.array(J, dtype=np.float64)
    rows = []
    for k in range(A.shape[0]):
        idx = k + int(np.argmax(np.abs(A[k:, k])))
        rows.append(idx)
        A[[k, idx]] = A[[idx, k]]
        A[k + 1:] -= np.outer(A[k + 1:, k] / A[k, k], A[k])
    return rows


def _swapping(rng, n, count):
    """``count`` n x n systems whose elimination swaps rows at every step
    that can (each step but the last): P L U with a unit lower L whose
    entries are below 1 in size, so the pivots follow P, rejected until
    every step's pivot row is not its own."""
    out = []
    while len(out) < count:
        L = np.tril(rng.uniform(-0.9, 0.9, (n, n)), -1) + np.eye(n)
        U = np.triu(rng.normal(size=(n, n)), 1) + np.diag(
            rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n))
        J = (L @ U)[rng.permutation(n)]
        if all(p != k for k, p in enumerate(_pivots(J)[:-1])):
            out.append(J)
    return np.stack(out)


def test_swapping_cases_swap_every_step():
    for n, m, J, B in _swapping_cases():
        for Ji in J:
            for dt in (np.float64, np.float32):
                rows = _pivots(Ji.astype(dt))
                assert all(p != k for k, p in enumerate(rows[:-1])), (n, rows)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_solve_dense_bitwise(out_dir, f64):
    cm = compile_model(TM.diodeclipper_model(), device="cpu")
    lib = load_engine_host(cm._header, out_dir)
    dt = np.float64 if f64 else np.float32
    for n, m, J, B in _hard_cases():
        J, B = J.astype(dt), B.astype(dt)
        X = np.zeros(B.shape, dt)
        ok = np.zeros(J.shape[0], np.uint8)
        rc = lib.acme_dense_host(n, m, J.shape[0], int(f64), J.ctypes.data,
                                 B.ctypes.data, X.ctypes.data, ok.ctypes.data)
        assert rc == 0
        Xp, okp = solve_dense(torch.as_tensor(J), torch.as_tensor(B))
        assert np.array_equal(ok.astype(bool), okp.numpy()), (n, m)
        assert np.array_equal(X, Xp.numpy(), equal_nan=True), (n, m)


# -- the whole run -------------------------------------------------------------

def _against_plain(out_dir, cm, state, src, T):
    """The host build of cm's kernel against cm's plain scan from
    ``state``: y within KERNEL_DB of each lane's peak, converged equal;
    returns (y, converged) of the plain version."""
    lib = load_engine_host(cm._header, out_dir)
    L = state["x"].shape[0]
    sh, (yh, ch, ih) = cm.host_scan(lib, state, src, T)
    sp, (yp, cp, ip) = cm._plain_scan(state, src, T, cm._mats())
    yh, yp = yh.double().numpy(), yp.double().numpy()
    assert np.isfinite(yh).all()
    err = np.abs(yh - yp).max(axis=(0, 2))
    peak = np.maximum(np.abs(yp).max(axis=(0, 2)), 1e-30)
    db = 20 * np.log10(err / peak + 1e-300)
    assert db.max() < KERNEL_DB, db
    assert torch.equal(ch, cp)
    assert ih.shape == ip.shape == (T, L, cm.nsub)
    for a, b in zip([sh["x"]] + [v for w in sh["warms"] for v in w],
                    [sp["x"]] + [v for w in sp["warms"] for v in w]):
        if b.numel() == 0:
            continue
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) / scale < 1e-7
    return yp, cp


def _series(u):
    u = torch.as_tensor(u)
    return _Src(umap=tuple((2, i) for i in range(u.shape[1])), ul=u)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_clipper(out_dir, dtype):
    cm = compile_model(TM.diodeclipper_model(), dtype=dtype, device="cpu")
    amps = np.linspace(0.1, 3.0, 8)
    u = (amps[:, None, None] * _sine(256)[None, None]).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    _, conv = _against_plain(out_dir, cm, cm.initial_state(8), _series(u),
                             256)
    assert bool(conv.all())


def test_birdie_lane_input(out_dir):
    cm = compile_model(TM.birdie_model(), device="cpu")
    vols = torch.as_tensor(np.linspace(0.05, 0.95, 8)[:, None])
    src = cm._sweep_src(cm._as(0.3 * _sine(128)[None]), vols, (1,))
    _against_plain(out_dir, cm, cm.initial_state(8), src, 128)


def _clipper(r):
    circ = TM.diodeclipper()
    circ.delete("r1")
    circ.add("r1", TT.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return TT.DiscreteModel(circ, 1 / 44100)


def test_four_clippers_per_lane(out_dir):
    bm = compile_models([_clipper(r) for r in (820.0, 1000.0, 1500.0,
                                              4700.0)], device="cpu")
    u = torch.as_tensor(2.0 * _sine(256)[None, None]).expand(4, 1, 256)
    yp, _ = _against_plain(out_dir, bm, bm.initial_state(), _series(u), 256)
    assert np.abs(yp[:, 0] - yp[:, 3]).max() > 1e-3


def test_superover_from_seeds(out_dir):
    m = S.build_model("pots", "chain")
    _, _, _, lv, _ = S.lane_grid("pots", 4096)
    lanes = lv[[0, 1365, 3224, 4095]]
    cm = compile_model(copy.deepcopy(m), tol=1e-12, device="cpu")
    seed = compile_model(copy.deepcopy(m), tol=1e-9, device="cpu") \
        .steady_initial_state(lanes, (1, 2))
    src = cm._sweep_src(cm._as(0.2 * _sine(64)[None]), cm._as(lanes), (1, 2))
    _, conv = _against_plain(out_dir, cm, seed, src, 64)
    assert bool(conv.all())


def test_nonconvergence_circuit(out_dir):
    circ = TT.Circuit()
    circ.add("d", TT.diode())
    circ.add("src", TT.currentsource())
    circ.connect(("src", "+"), ("d", "+"))
    circ.connect(("src", "-"), ("d", "-"))
    circ.add("probe", TT.voltageprobe())
    circ.connect(("probe", "+"), ("d", "+"))
    circ.connect(("probe", "-"), ("d", "-"))
    cm = compile_model(TT.DiscreteModel(circ, 1), device="cpu")
    u = np.array([[[1.0, 1.0, -1.0, 0.5]], [[-1.0, 1.0, 1.0, 1.0]]])
    _, conv = _against_plain(out_dir, cm, cm.initial_state(2), _series(u), 4)
    assert not bool(conv.all()) and bool(conv.any())


def test_shared_and_per_lane_blocks_bitwise(out_dir):
    """One model's block read by every lane (lane stride 0: on the card
    staged into shared memory) against the same model as 37 per-lane blocks
    (``compile_models`` of copies: on the card read from device memory),
    from one state: bit for bit in y, state, converged and iters."""
    m = TM.diodeclipper_model()
    cm = compile_model(copy.deepcopy(m), device="cpu")
    bm = compile_models([copy.deepcopy(m) for _ in range(37)], device="cpu")
    assert cm._header == bm._header
    lib = load_engine_host(cm._header, out_dir)
    nmat = cm._layout["nmat"]
    assert cm.smem_bytes(lib, True) - cm.smem_bytes(lib, False) == 8 * nmat
    u = np.linspace(0.1, 3.0, 37)[:, None, None] * _sine(128)[None, None]
    state = cm.initial_state(37)
    s1, out1 = cm.host_scan(lib, state, _series(u), 128)
    s2, out2 = bm.host_scan(lib, state, _series(u), 128)
    assert cm._blocks.shape[0] == 1 and bm._blocks.shape[0] == 37
    for a, b in zip(list(out1) + _state_leaves(s1),
                    list(out2) + _state_leaves(s2)):
        assert torch.equal(a, b)


def _state_leaves(st):
    return [st["x"]] + [v for w in st["warms"] for v in w]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_ragged_lane_count(out_dir, dtype):
    """37 lanes (the card's last 32-lane block holds 5) against the plain
    scan, and its first 32 lanes bit for bit as a 32-lane run of them."""
    cm = compile_model(TM.birdie_model(), dtype=dtype, device="cpu")
    vols = np.linspace(0.05, 0.95, 37)[:, None]
    u = cm._as(0.3 * _sine(96)[None])
    src = cm._sweep_src(u, cm._as(vols), (1,))
    _against_plain(out_dir, cm, cm.initial_state(37), src, 96)
    lib = load_engine_host(cm._header, out_dir)
    s37, out37 = cm.host_scan(lib, cm.initial_state(37), src, 96)
    s32, out32 = cm.host_scan(lib, cm.initial_state(32), cm._sweep_src(
        u, cm._as(vols[:32]), (1,)), 96)
    for a, b in zip(out37, out32):              # (T, L, ...)
        assert torch.equal(a[:, :32], b)
    for a, b in zip(_state_leaves(s37), _state_leaves(s32)):
        assert torch.equal(a[:32], b)
