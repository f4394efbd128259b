"""The CUDA kernel against its plain version, on the card.

Needs a CUDA card and nvcc; skips without one.  This file imports no jax
and nothing of acme_tpu, so it also runs where jax is not installed (the
repo's root conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Bound as in tests/test_torch_fused.py: y within -90 dB of each lane's
peak (bit-identical on the H100 so far), fails and floored equal.  The
float64 scan engine's kernel (``csrc/scan.cu``) against its plain scan:
y within -180 dB of each lane's peak, converged equal; its split over
(cuda:0, cuda:0) bit for bit as unsplit; its two instantiations (the model
block shared by every lane, staged in shared memory, and per-lane blocks
in device memory) bit for bit with each other on a ragged lane count.
The main path's production build compiles with no stack frame and no
spills (ptxas's report).
"""

import copy

import numpy as np
import pytest
import torch

import acme_tpu_torch as T
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.models import (birdie_model, diodeclipper,
                                   diodeclipper_model)
from acme_tpu_torch.ops import fused as F
from torch_step_configs import CONFIGS, LEVEL_CONFIGS

FS = 44100
# the JAX bench's production configuration, which these builds hold
PROD = S.PRODUCTION
CASES = {
    "clipper": (diodeclipper_model, (), 1.5, None),
    "birdie": (birdie_model, (1,), 0.3, np.linspace(0.05, 0.95, 128)[:, None]),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    return torch.device("cuda", 0)


def _kernel_vs_plain(tr, u_time, lv, st):
    """One launch against plain_run on the same CUDA tensors; returns the
    kernel's state."""
    u, lvt, tol, gate = tr.prepare_inputs(u_time, lv)
    coef = tr._coef_tables(lvt.shape[1])
    before = sum(F.LAUNCHES.values())
    yk, sk, fk, _, flk = F.fused_step(tr.plan, u, lvt, tol, gate, st, coef)
    assert sum(F.LAUNCHES.values()) == before + 1
    assert F.LAUNCHES[tr.plan.cuda_name] >= 1
    yp, sp, fp, _, flp = F.plain_run(tr.plan, u, lvt, tol, gate, st, coef)
    yk, yp = yk.double().cpu().numpy(), yp.double().cpu().numpy()
    assert np.isfinite(yk).all()
    err = np.abs(yk - yp).max(axis=(0, 1))
    peak = np.maximum(np.abs(yp).max(axis=(0, 1)), 1e-30)
    assert (20 * np.log10(err / peak + 1e-300)).max() < -90.0
    assert torch.equal(fk, fp) and torch.equal(flk, flp)
    return sk


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case):
    dev = _card()
    build, lidx, amp, lv = CASES[case]
    lv = np.zeros((128, 0)) if lv is None else lv
    tr = FusedRunner(build(), lane_input_idx=lidx, **PROD, device=dev)
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(64)))[None, :]
    _kernel_vs_plain(tr, u_time, lv, tr.initial_state(128))


def clipper_with_r1(r):
    """The diode clipper with another series resistor."""
    circ = diodeclipper()
    circ.delete("r1")
    circ.add("r1", T.resistor(r))
    circ.connect(("r1", 1), ("j_in", "+"))
    circ.connect(("r1", 2), ("d1", "+"))
    return T.DiscreteModel(circ, 1 / 44100)


@pytest.mark.cuda
def test_per_lane_models_match_plain_on_card():
    """Four clippers as the per-lane models of one runner: the kernel
    reads the two varying coefficients from the tables it is handed."""
    dev = _card()
    tr = FusedRunner([clipper_with_r1(r) for r in (820.0, 1000.0, 1500.0,
                                                   4700.0)], **PROD,
                     device=dev)
    assert tr.nvar > 0
    u_time = (2.0 * np.sin(2 * np.pi * 1000 / FS * np.arange(200)))[None, :]
    _kernel_vs_plain(tr, u_time, np.zeros((128, 0)), tr.initial_state(128))
    y, _, _ = tr.run(u_time, np.zeros((128, 0)))
    assert float((y[0] - y[3]).abs().max()) > 1e-3
    assert torch.equal(y[0], y[4])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["clipper", "superover_level",
                                   "superover_presets", "superover_full"])
def test_level_builds_match_plain_on_card(model):
    """The two builds of a sweep over input levels: the power-up sibling
    from cold with lane-scaled inputs, then the production build from its
    state; for the level sweep's models, for the presets sweep's list of
    models (per-lane coefficient tables) and for the un-decomposed Super
    Over (a 7x7 df elimination under the fold loop)."""
    dev = _card()
    lv = np.linspace(0.1, 2.0, 128)[:, None]
    if model == "clipper":
        fr = FusedRunner(diodeclipper_model(), lane_scale_idx=(0,),
                         powerup="safe", **PROD, device=dev)
        amp = 1.5
    elif model == "superover_presets":
        fr = FusedRunner(S.build_presets(FS), powerup="safe", **PROD,
                         device=dev,
                         **S.lane_grid("presets", 128)[4])
        assert fr.nvar > 0
        lv = S.lane_grid("presets", 128)[3]
        amp = 0.2
    else:
        variant = "full" if model == "superover_full" else "chain"
        fr = FusedRunner(S.build_model("level", variant),
                         lane_scale_idx=(0,), powerup="safe", **PROD,
                         device=dev)
        amp = 0.2
    pr = fr._powerup_runner()
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(32)))[None, :]
    st = _kernel_vs_plain(pr, u_time, lv, pr.initial_state(128))
    _kernel_vs_plain(fr, u_time, lv, {k: v.contiguous()
                                      for k, v in st.items()})


@pytest.fixture(scope="module")
def config_runners():
    """A runner per (model, configuration), their builds compiled
    together (one nvcc each, started at once)."""
    from concurrent.futures import ThreadPoolExecutor
    from acme_tpu_torch.ops.build import compile_library, load_kernel
    dev = _card()
    level = S.build_model("level", "chain")
    runners = {("clipper", c): FusedRunner(
        diodeclipper_model(), lane_scale_idx=(0,), **kw, device=dev)
        for c, kw in CONFIGS.items()}
    for c in LEVEL_CONFIGS:
        runners["superover_level", c] = FusedRunner(
            copy.deepcopy(level), lane_scale_idx=(0,), **CONFIGS[c],
            device=dev)
    with ThreadPoolExecutor(len(runners)) as ex:
        list(ex.map(lambda r: compile_library(r.plan), runners.values()))
    for r in runners.values():
        load_kernel(r.plan)
    return runners


@pytest.mark.cuda
@pytest.mark.parametrize("model,config",
                         [("clipper", c) for c in CONFIGS]
                         + [("superover_level", c) for c in LEVEL_CONFIGS])
def test_configurations_match_plain_on_card(config_runners, model, config):
    """Each step configuration's build from cold, 128 input levels x 64
    samples (the clipper at a 1.5, the level Super Over at a 0.2
    amplitude), against the plain version on the same card."""
    fr = config_runners[model, config]
    amp = 1.5 if model == "clipper" else 0.2
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(64)))[None, :]
    _kernel_vs_plain(fr, u_time, np.linspace(0.1, 2.0, 128)[:, None],
                     fr.initial_state(128))


@pytest.mark.cuda
def test_lane_groups_match_plain_on_card():
    """A build that couples lane groups (cooperative launch, a barrier in
    device memory at every keep test) on the clipper, two groups of 1024
    lanes x 64 samples, the first group's levels where keep tests fail,
    the second's where they never do: bit for bit as the plain version in
    y, state, fails, floored and iters; the redo reaches the passing lanes
    of the first group only (against the merge build); and a grid of
    262144 lanes, more than the card holds resident at once, runs in
    batches of whole groups and equals its 128 groups of 2048 run one at
    a time, bit for bit in y, state, fails, iters and floored, as does its
    traced launch (a stats buffer: the traced step's batches, of its own
    resident count), which counts every lane's solves."""
    dev = _card()
    from acme_tpu_torch import trace
    rng = np.random.default_rng(5)
    lv = np.concatenate([rng.uniform(0.01, 3.0, 1024),
                         rng.uniform(0.01, 0.05, 1024)])[:, None]
    u_time = (1.5 * np.sin(2 * np.pi * 1000 / FS * np.arange(64)))[None, :]
    its = {}
    for mode in ("group", "merge"):
        fr = FusedRunner(diodeclipper_model(), lane_scale_idx=(0,),
                         **dict(PROD, fast_verify=mode, group_lanes=1024),
                         device=dev)
        u, lvt, tol, gate = fr.prepare_inputs(u_time, lv)
        args = (fr.plan, u, lvt, tol, gate, fr.initial_state(2048),
                fr._coef_tables(2048), fr._group(2048))
        before = sum(F.LAUNCHES.values())
        kern = F.fused_step(*args)
        assert sum(F.LAUNCHES.values()) == before + 1
        plain = F.plain_run(*args)
        for name, k, p in zip(("y", "state", "fails", "iters", "floored"),
                              kern, plain):
            if name == "state":
                for key in p:
                    assert torch.equal(k[key], p[key]), key
            else:
                assert torch.equal(k, p), name
        its[mode] = kern[3].cpu()
    moved = (its["group"] != its["merge"]).any(0)
    assert moved[:1024].any() and not moved[1024:].any()
    fr = FusedRunner(diodeclipper_model(), lane_scale_idx=(0,),
                     **dict(PROD, fast_verify="group"), device=dev)
    L = 1 << 18
    Lg = fr.group_size(L)
    assert 0 < F.resident_lanes(fr.plan, dev, Lg) < L
    u, lvt, tol, gate = fr.prepare_inputs(
        u_time[:, :16], rng.uniform(0.01, 3.0, L)[:, None])
    lane_args = [lvt, tol, gate, *fr._coef_tables(L)]
    st = fr.initial_state(L)
    before = sum(F.LAUNCHES.values())
    whole = F.fused_step(fr.plan, u, *lane_args[:3], st, lane_args[3:], Lg)
    assert sum(F.LAUNCHES.values()) == before + 1
    assert 0 < F.resident_lanes(fr.plan, dev, Lg, traced=True) < L
    stats = torch.zeros((len(trace.COUNTERS), max(fr.nsub, 1), L),
                        dtype=torch.int64, device=dev)
    _bit_for_bit(F.fused_step(fr.plan, u, *lane_args[:3], st, lane_args[3:],
                              Lg, stats=stats), whole)
    assert (stats[trace.COUNTERS.index("solves")] == 16).all()
    parts = []
    for g in range(0, L, Lg):
        lv_g, tol_g, gate_g, ch, cl = [t[:, g:g + Lg].contiguous()
                                       for t in lane_args]
        parts.append(F.fused_step(
            fr.plan, u, lv_g, tol_g, gate_g,
            {k: v[:, g:g + Lg].contiguous() for k, v in st.items()},
            (ch, cl), Lg))
    y, states, fails, iters, floored = zip(*parts)
    assert torch.equal(whole[0], torch.cat(y, 2))
    for k in whole[1]:
        assert torch.equal(whole[1][k], torch.cat([s_[k] for s_ in states],
                                                  1)), k
    assert torch.equal(whole[2], torch.cat(fails))
    assert torch.equal(whole[3], torch.cat(iters, 1))
    assert torch.equal(whole[4], torch.cat(floored))
    assert (whole[3] > whole[3].min()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["production", "group"])
def test_mesh_of_one_card_matches_one_device(config):
    """A mesh that names the card twice, ``(cuda:0, cuda:0)``: two entries
    of 2048 lanes, each launched on a stream of its own, gathered on the
    card; the level sweep from cold (its power-up sibling inherits the
    mesh) in the production configuration, and lane groups of 2048 (the
    same partition split or not): bit for bit as one device in y, state,
    fails, iters and floored, with one launch per entry and build."""
    dev = _card()
    kw = dict(PROD, powerup="safe", powerup_samples=16)
    if config == "group":
        kw.update(fast_verify="group", group_lanes=2048)
    lv = np.random.default_rng(5).uniform(0.01, 3.0, 4096)[:, None]
    u_time = (1.5 * np.sin(2 * np.pi * 1000 / FS * np.arange(48)))[None, :]
    runs = []
    for mesh in ((dev, dev), None):
        fr = FusedRunner(diodeclipper_model(), lane_scale_idx=(0,),
                         device=dev, mesh=mesh, **kw)
        assert fr.group_size(4096) == 2048
        F.LAUNCHES.clear()
        runs.append(fr.run(u_time, lv))
        torch.cuda.synchronize()
        assert sum(F.LAUNCHES.values()) == (4 if mesh else 2)
        assert len(F.LAUNCHES) == 2
    (ym, sm, im), (y1, s1, i1) = runs
    assert torch.equal(ym, y1)
    for k in s1:
        assert torch.equal(sm[k], s1[k]), k
    for a, b in zip(im, i1):
        # tiers: None while tracing is off
        assert (a is None and b is None) or torch.equal(a, b)


def _bit_for_bit(got, want):
    for name, a, b in zip(("y", "state", "fails", "iters", "floored"), got,
                          want):
        if name == "state":
            for key in b:
                assert torch.equal(a[key], b[key]), key
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["main", "full"])
def test_production_builds_bit_for_bit_on_card(path):
    """The main and full paths' production builds, one launch each, bit
    for bit as the plain version in y, state, fails, iters and floored.
    The main path: 512 lanes of the committed seeds x 16 samples, lane 3
    started off its steady point so that it takes the redo ladder while
    the other lanes of its warp do not; the full path: 128 input levels,
    its power-up sibling's 16 samples from cold, then 8 of the production
    build."""
    dev = _card()
    import os
    from acme_tpu_torch.convert import load_steady_seed
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    u_time = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(32)))[None, :]
    if path == "main":
        fr = FusedRunner(S.build_model("pots", "chain"), device=dev,
                         lane_input_idx=(1, 2), powerup="steady", **PROD)
        lv = S.lane_grid("pots", 4096)[3][:512]
        st = load_steady_seed(os.path.join(root, ".steadyseed_cache.npz"),
                              "seed2_pots_chain_fs44100_L4096", fr,
                              lanes=np.arange(len(lv)))
        st["zw"][:, 3] *= 0.9
        st["dzdp"][:, 3] = 0.0
        ut = u_time[:, :16]
    else:
        fr = FusedRunner(S.build_model("level", "full"), device=dev,
                         lane_scale_idx=(0,), powerup="safe",
                         powerup_samples=16, **PROD)
        lv = np.linspace(0.1, 2.0, 128)[:, None]
        _, st, _ = fr._powerup_runner().run(u_time[:, :16], lv)
        ut = u_time[:, 16:24]
    u, lvt, tol, gate = fr.prepare_inputs(ut, lv)
    args = (fr.plan, u, lvt, tol, gate, st, fr._coef_tables(len(lv)))
    before = sum(F.LAUNCHES.values())
    got = F.fused_step(*args)
    assert sum(F.LAUNCHES.values()) == before + 1
    _bit_for_bit(got, F.plain_run(*args))
    if path == "main":
        its = got[3].cpu().numpy()
        assert (its[:, 3] > np.delete(its, 3, axis=1).max(axis=1)).any()


# the main path's production build and the full path's two: the most
# stack frame ptxas may report for their kernel entry (nothing of the
# working set belongs in local memory, csrc/fused.cu)
FRAME_BYTES = 0


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["main", "full", "full_powerup"])
def test_main_build_has_no_frame_on_card(build):
    """The main path's production build and the full path's (the
    un-decomposed Super Over's production build and its power-up sibling),
    compiled for the card: ptxas reports each kernel entry with at most
    FRAME_BYTES of stack frame and no spill stores or loads."""
    _card()
    import re
    from acme_tpu_torch.ops import build as B
    if build == "main":
        fr = FusedRunner(S.build_model("pots", "chain"), device="cuda",
                         lane_input_idx=(1, 2), powerup="steady", **PROD)
    else:
        fr = FusedRunner(S.build_model("level", "full"), device="cuda",
                         lane_scale_idx=(0,), powerup="safe", **PROD)
        if build == "full_powerup":
            fr = fr._powerup_runner()
    _, out = B.build_log(B.compile_library(fr.plan))
    rows = re.findall(r"Function properties for \S*acme_fused_kernel\S*\s+"
                      r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", out)
    assert rows, out
    for frame, stores, loads in rows:
        assert int(frame) <= FRAME_BYTES, out
        assert int(stores) == 0 and int(loads) == 0, out


@pytest.mark.cuda
def test_tier_counters_on_card(tmp_path):
    """The kernel's tier counters (``trace``) on the full path, 256 input
    levels: its power-up sibling's 16 samples from cold, then 16 of the
    production build, alone and over the mesh (cuda:0, cuda:0).  Each
    launch's outputs are bit for bit with the stats buffer set and unset;
    its counts equal the host build's for the same inputs, the evaluations
    of the fast, polish and redo tiers sum to iters and the redos are at
    most the solves, T x nsub; every lane's tier cycles sum to no more
    than its launch's, which the card counts."""
    dev = _card()
    from acme_tpu_torch import trace
    from acme_tpu_torch.ops.build import load_host
    model = S.build_model("level", "full")
    fr = FusedRunner(copy.deepcopy(model), device=dev, lane_scale_idx=(0,),
                     powerup="safe", powerup_samples=16, **PROD)
    L, T = 256, 16
    lv = np.linspace(0.1, 2.0, L)[:, None]
    u_time = (0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(2 * T)))[None]
    state = None
    for r, ut in ((fr._powerup_runner(), u_time[:, :T]),
                  (fr, u_time[:, T:])):
        u, lvt, tol, gate = r.prepare_inputs(ut, lv)
        st = r.initial_state(L) if state is None else state
        args = (r.plan, u, lvt, tol, gate, st, r._coef_tables(L))
        shape = (len(trace.COUNTERS), max(r.nsub, 1), L)
        stats = torch.zeros(shape, dtype=torch.int64, device=dev)
        got = F.fused_step(*args, stats=stats)
        _bit_for_bit(got, F.fused_step(*args))
        host = torch.zeros(shape, dtype=torch.int64)
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args[1:5]]
        F.host_step(load_host(r.plan, str(tmp_path)), r.plan, *cpu,
                    {k: v.cpu() for k, v in st.items()},
                    tuple(c.cpu() for c in r._coef_tables(L)), stats=host)
        c = {k: stats[i].cpu() for i, k in enumerate(trace.COUNTERS)}
        for i, k in enumerate(trace.COUNTERS[6:], 6):
            assert torch.equal(c[k], host[i]), k
        assert torch.equal(c["ev_fast"] + c["ev_polish"] + c["ev_redo"],
                           got[3].cpu().long())
        assert (c["solves"] == T).all()
        assert (c["redos"] <= c["solves"]).all()
        tiers = sum(c[k] for k in trace.TIERS).sum(0)
        assert (c["total"][0] > 0).all()
        assert (tiers <= c["total"].sum(0)).all()
        state = got[1]
    trace.clear()
    with trace.recording():
        _, _, one = fr.run(u_time[:, T:], lv, state=st)
        mesh = FusedRunner(copy.deepcopy(model), device=dev,
                           mesh=(dev, dev), lane_scale_idx=(0,),
                           powerup="safe", powerup_samples=16, **PROD)
        _, _, two = mesh.run(u_time[:, T:], lv, state=st)
    assert one.tiers.shape == two.tiers.shape == shape
    assert torch.equal(one.tiers[6:], two.tiers[6:])


# -- the float64 scan engine (csrc/scan.cu) -----------------------------------

ENGINE_DB = -180.0


def _engine_vs_plain(cm, src, state, T):
    """One launch of the scan kernel against the plain scan on the same
    CUDA tensors: y within ENGINE_DB of each lane's peak, converged equal
    (bit-identical on the H100 so far)."""
    from acme_tpu_torch import engine as E
    before = sum(E.LAUNCHES.values())
    sk, (yk, ck, ik) = cm._scan(state, src, T)
    assert sum(E.LAUNCHES.values()) == before + 1
    assert E.LAUNCHES[cm.launch_key()] >= 1
    sp, (yp, cp, ip) = cm._plain_scan(state, src, T, cm._mats())
    assert bool(torch.isfinite(yk).all())
    err = (yk - yp).abs().amax(dim=(0, 2)).double()
    peak = yp.abs().amax(dim=(0, 2)).double().clamp(min=1e-30)
    assert float((20 * torch.log10(err / peak + 1e-300)).max()) < ENGINE_DB
    assert torch.equal(ck, cp)
    return yk, ck


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["clipper", "clipper_f32", "birdie",
                                  "four_clippers", "nonconvergence"])
def test_engine_matches_plain_on_card(case):
    from acme_tpu_torch.engine import _Src, compile_model, compile_models
    dev = _card()
    series = lambda cm, a: _Src(umap=tuple((2, i) for i in range(cm.nu)),
                                ul=cm._as(a))
    s = np.sin(2 * np.pi * 1000 / FS * np.arange(256))
    if case in ("clipper", "clipper_f32"):
        cm = compile_model(diodeclipper_model(), device=dev,
                           dtype=torch.float32 if case == "clipper_f32"
                           else torch.float64)
        src = series(cm, np.linspace(0.1, 3.0, 128)[:, None, None]
                     * s[None, None])
        state = cm.initial_state(128)
    elif case == "birdie":
        cm = compile_model(birdie_model(), device=dev)
        src = cm._sweep_src(cm._as(0.3 * s[None]),
                            cm._as(np.linspace(0.05, 0.95, 128)[:, None]),
                            (1,))
        state = cm.initial_state(128)
    elif case == "four_clippers":
        cm = compile_models([clipper_with_r1(r) for r in
                             (820.0, 1000.0, 1500.0, 4700.0)], device=dev)
        src = series(cm, np.tile(2.0 * s, (4, 1, 1)))
        state = cm.initial_state()
    else:
        circ = T.Circuit()
        circ.add("d", T.diode())
        circ.add("src", T.currentsource())
        circ.connect(("src", "+"), ("d", "+"))
        circ.connect(("src", "-"), ("d", "-"))
        circ.add("probe", T.voltageprobe())
        circ.connect(("probe", "+"), ("d", "+"))
        circ.connect(("probe", "-"), ("d", "-"))
        cm = compile_model(T.DiscreteModel(circ, 1), device=dev)
        src = series(cm, np.array([[[1.0, 1.0, -1.0, 0.5]],
                                   [[-1.0, 1.0, 1.0, 1.0]]]))
        state = cm.initial_state(2)
    _, conv = _engine_vs_plain(cm, src, state, src.ul.shape[2]
                               if src.ul is not None else 256)
    if case == "nonconvergence":
        assert not bool(conv.all()) and bool(conv.any())
    else:
        assert bool(conv.all())


@pytest.mark.cuda
def test_engine_superover_and_split_on_card():
    """The chain Super Over at the references' tolerance from steady seeds
    (4 lanes of the main path's grid, tiled to 128) x 64 samples against
    the plain scan; then over the mesh (cuda:0, cuda:0), bit for bit as
    unsplit."""
    import copy
    from acme_tpu_torch.engine import compile_model
    from acme_tpu_torch.ops.newton import WarmStart
    from acme_tpu_torch.parallel import sharded_run_sweep
    dev = _card()
    m = S.build_model("pots", "chain")
    lv = S.lane_grid("pots", 4096)[3][[0, 1365, 3224, 4095]]
    cm = compile_model(copy.deepcopy(m), tol=1e-12, device=dev)
    seed = compile_model(copy.deepcopy(m), tol=1e-9, device="cpu") \
        .steady_initial_state(lv, (1, 2))
    tile = lambda v: v.repeat((32,) + (1,) * (v.dim() - 1)).to(dev)
    state = {"x": tile(seed["x"]),
             "warms": tuple(WarmStart(*(tile(v) for v in w))
                            for w in seed["warms"])}
    lv = np.tile(lv, (32, 1))
    u = 0.2 * np.sin(2 * np.pi * 1000 / FS * np.arange(64))[None]
    src = cm._sweep_src(cm._as(u), cm._as(lv), (1, 2))
    _, conv = _engine_vs_plain(cm, src, state, 64)
    assert bool(conv.all())
    whole = cm.run_sweep(u, lv, (1, 2), state=state)
    split = sharded_run_sweep(cm, u, lv, (1, 2), (dev, dev), state=state)
    assert torch.equal(whole[0], split[0])
    assert torch.equal(whole[2].iters, split[2].iters)
    assert torch.equal(whole[2].converged, split[2].converged)
    for a, b in zip([whole[1]["x"]] + [v for w in whole[1]["warms"]
                                       for v in w],
                    [split[1]["x"]] + [v for w in split[1]["warms"]
                                       for v in w]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_engine_shared_and_per_lane_blocks_on_card():
    """The clipper as one model (lane stride 0: the block staged in shared
    memory) and as 100 per-lane copies (``compile_models``: the blocks read
    from device memory) on the same 100 lanes x 256 samples (the last
    32-lane block holds 4): bit for bit with each other in y, state,
    converged and iters, each within -180 dB of the plain scan with
    converged equal."""
    from acme_tpu_torch.engine import _Src, compile_model, compile_models
    dev = _card()
    cm = compile_model(diodeclipper_model(), device=dev)
    bm = compile_models([diodeclipper_model() for _ in range(100)],
                        device=dev)
    u = np.linspace(0.1, 3.0, 100)[:, None, None] * np.sin(
        2 * np.pi * 1000 / FS * np.arange(256))[None, None]
    src = _Src(umap=((2, 0),), ul=cm._as(u))
    state = cm.initial_state(100)
    runs = []
    for m in (cm, bm):
        _engine_vs_plain(m, src, state, 256)
        runs.append(m._scan(state, src, 256))
    (s1, out1), (s2, out2) = runs
    for a, b in zip(list(out1) + [s1["x"]] + [v for w in s1["warms"]
                                              for v in w],
                    list(out2) + [s2["x"]] + [v for w in s2["warms"]
                                              for v in w]):
        assert torch.equal(a, b)
