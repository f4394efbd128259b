"""``acme_tpu_torch.sweeps`` against the JAX package's bench helpers.

The port keeps its own copy of the bench's lane grids, parity-lane rule
and reference-key format, so ``chip_smoke.py`` picks exactly the lanes
``.hostref_cache.npz`` holds references for without importing ``bench``.
"""

import os

import numpy as np
import pytest

import bench
from acme_tpu_torch import sweeps as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sweep", ["pots", "level"])
@pytest.mark.parametrize("L", [128, 1000, 4096])
def test_lane_grid_equal(sweep, L):
    for a, b in zip(bench._lane_grid(sweep, L), S.lane_grid(sweep, L),
                    strict=True):
        if isinstance(a, np.ndarray) or a is None:
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("sweep", ["pots", "level"])
@pytest.mark.parametrize("L,K", [(4096, 16), (4096, 8), (128, 16), (3, 16)])
def test_parity_lanes_equal(sweep, L, K):
    assert bench._stress_lanes(sweep, L) == S.stress_lanes(sweep, L)
    stress = bench._stress_lanes(sweep, L)
    assert bench._select_parity_lanes(L, K, stress) == \
        S.select_parity_lanes(L, K, stress)


class _Args:
    fs = 44100


@pytest.mark.parametrize("sweep,variant,reps,powerup", [
    ("pots", "chain", 5, "steady"), ("level", "chain", 2, "safe"),
    ("level", "full", 2, "safe")])
def test_ref_keys_equal(sweep, variant, reps, powerup, monkeypatch,
                        tmp_path):
    """The bench's key for each parity lane (read off ``_parity_refs`` with
    a cache that holds every key it asks for) equals ``ref_key``'s, and the
    committed cache holds the 4096-lane sweeps' keys."""
    L = 4096
    levels, drive, tone, _, _ = S.lane_grid(sweep, L)

    def params(i):
        return (float(levels[i]) if levels is not None else 1.0,
                float(drive[i]) if drive is not None else 1.0,
                float(tone[i]) if tone is not None else 1.0)

    lanes = S.select_parity_lanes(L, 16 if variant == "chain" else 8,
                                  S.stress_lanes(sweep, L))
    keys = [S.ref_key(sweep, variant, 44100, 44100, reps, *params(i),
                      powerup=powerup) for i in lanes]
    with np.load(os.path.join(ROOT, ".hostref_cache.npz")) as cache:
        assert all(k + "_pw" in cache and k + "_st" in cache for k in keys)
    # a cache holding exactly these keys, with the lane index as data:
    # the bench returns every lane, so it computed the same keys
    path = tmp_path / "refs.npz"
    np.savez(path, **{k + s: np.full(2, float(i)) for k, i in
                      zip(keys, lanes) for s in ("_pw", "_st")})
    monkeypatch.setenv("ACME_TPU_HOSTREF_CACHE", str(path))
    got, sel = bench._parity_refs(_Args(), sweep, variant, 44100, reps,
                                  powerup, lanes, params, cached_only=True)
    assert sel == lanes
    assert [float(pw[0]) for pw, _ in got] == [float(i) for i in lanes]


@pytest.mark.parametrize("sweep", ["pots", "level"])
@pytest.mark.parametrize("variant", ["chain", "full"])
def test_build_model_matches_bench(sweep, variant, monkeypatch):
    """Same model function, same arguments (the functions themselves are
    held equal by tests/test_torch_compiler.py)."""
    import acme_tpu.models as JM
    calls = []
    record = lambda **kw: calls.append(kw) or len(calls)
    monkeypatch.setattr(JM, "superover_model", record)
    monkeypatch.setattr(S, "superover_model", record)
    bench._build_model(sweep, variant, 48000)
    S.build_model(sweep, variant, 48000)
    assert len(calls) == 2 and calls[0] == calls[1]
