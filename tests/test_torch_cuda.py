"""The CUDA kernel against its plain version, on the card.

Needs a CUDA card and nvcc; skips without one.  This file imports no jax
and nothing of acme_tpu, so it also runs where jax is not installed (the
repo's root conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Bound as in tests/test_torch_fused.py: y within -90 dB of each lane's
peak (bit-identical on the H100 so far), fails and floored equal.
"""

import numpy as np
import pytest
import torch

import acme_tpu_torch as T
from acme_tpu_torch import FusedRunner
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.models import (birdie_model, diodeclipper,
                                   diodeclipper_model)
from acme_tpu_torch.ops import fused as F

FS = 44100
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
    tr = FusedRunner(build(), lane_input_idx=lidx, device=dev)
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
                                                   4700.0)], device=dev)
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
                         powerup="safe", device=dev)
        amp = 1.5
    elif model == "superover_presets":
        fr = FusedRunner(S.build_presets(FS), powerup="safe", device=dev,
                         **S.lane_grid("presets", 128)[4])
        assert fr.nvar > 0
        lv = S.lane_grid("presets", 128)[3]
        amp = 0.2
    else:
        variant = "full" if model == "superover_full" else "chain"
        fr = FusedRunner(S.build_model("level", variant),
                         lane_scale_idx=(0,), powerup="safe", device=dev)
        amp = 0.2
    pr = fr._powerup_runner()
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(32)))[None, :]
    st = _kernel_vs_plain(pr, u_time, lv, pr.initial_state(128))
    _kernel_vs_plain(fr, u_time, lv, {k: v.contiguous()
                                      for k, v in st.items()})
