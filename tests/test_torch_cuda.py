"""The CUDA kernel against its plain version, on the card.

Needs a CUDA card and nvcc; skips without one.  This file imports no jax,
so it also runs where jax is not installed (the repo's root conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Bound as in tests/test_torch_fused.py: y within -90 dB of each lane's
peak (bit-identical on the H100 so far), fails and floored equal.
"""

import numpy as np
import pytest
import torch

import acme_tpu_torch  # noqa: F401  (before acme_tpu: the import guard)
from acme_tpu.models import birdie_model, diodeclipper_model
from acme_tpu_torch import FusedRunner
from acme_tpu_torch.ops import fused as F

FS = 44100
CASES = {
    "clipper": (diodeclipper_model, (), 1.5, None),
    "birdie": (birdie_model, (1,), 0.3, np.linspace(0.05, 0.95, 128)[:, None]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    build, lidx, amp, lv = CASES[case]
    lv = np.zeros((128, 0)) if lv is None else lv
    tr = FusedRunner(build(), lane_input_idx=lidx,
                     device=torch.device("cuda", 0))
    u_time = (amp * np.sin(2 * np.pi * 1000 / FS * np.arange(64)))[None, :]
    u, lvt, tol, gate = tr.prepare_inputs(u_time, lv)
    st = tr.initial_state(128)
    before = F.KERNEL_LAUNCHES
    yk, sk, fk, _, flk = F.fused_step(tr.plan, u, lvt, tol, gate, st)
    assert F.KERNEL_LAUNCHES == before + 1
    yp, sp, fp, _, flp = F.plain_run(tr.plan, u, lvt, tol, gate, st)
    yk, yp = yk.double().cpu().numpy(), yp.double().cpu().numpy()
    assert np.isfinite(yk).all()
    err = np.abs(yk - yp).max(axis=(0, 1))
    peak = np.maximum(np.abs(yp).max(axis=(0, 1)), 1e-30)
    assert (20 * np.log10(err / peak + 1e-300)).max() < -90.0
    assert torch.equal(fk, fp) and torch.equal(flk, flp)
