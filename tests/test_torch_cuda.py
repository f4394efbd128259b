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

from acme_tpu_torch import FusedRunner
from acme_tpu_torch import sweeps as S
from acme_tpu_torch.models import birdie_model, diodeclipper_model
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
    before = sum(F.LAUNCHES.values())
    yk, sk, fk, _, flk = F.fused_step(tr.plan, u, lvt, tol, gate, st)
    assert sum(F.LAUNCHES.values()) == before + 1
    assert F.LAUNCHES[tr.plan.cuda_name] >= 1
    yp, sp, fp, _, flp = F.plain_run(tr.plan, u, lvt, tol, gate, st)
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


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["clipper", "superover_level"])
def test_level_builds_match_plain_on_card(model):
    """The level sweep's two builds: the power-up sibling from cold with
    lane-scaled inputs, then the production build from its state."""
    dev = _card()
    if model == "clipper":
        fr = FusedRunner(diodeclipper_model(), lane_scale_idx=(0,),
                         powerup="safe", device=dev)
        amp = 1.5
    else:
        fr = FusedRunner(S.build_model("level", "chain"),
                         lane_scale_idx=(0,), powerup="safe", device=dev)
        amp = 0.2
    pr = fr._powerup_runner()
    lv = np.linspace(0.1, 2.0, 128)[:, None]
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(32)))[None, :]
    st = _kernel_vs_plain(pr, u_time, lv, pr.initial_state(128))
    _kernel_vs_plain(fr, u_time, lv, {k: v.contiguous()
                                      for k, v in st.items()})
