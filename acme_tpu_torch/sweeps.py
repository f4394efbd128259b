"""The sweeps of the JAX package's bench: lane grids, parity lanes and the
keys of the committed float64 references.

The port's own copy of the rules in ``bench.py`` (``_build_model``,
``_lane_grid``, ``_select_parity_lanes``, ``_stress_lanes`` and the key
format of ``_parity_refs``), so that ``chip_smoke.py`` and the port's tests
pick the lanes that ``.hostref_cache.npz`` holds references for without
importing the bench.

    levels, drive, tone, lane_values, cfg = lane_grid("level", 4096)
    lanes = select_parity_lanes(4096, 16, stress_lanes("level", 4096))
    key = ref_key("level", "chain", 44100, 44100, 2, levels[i], 1.0, 1.0)
    y_pw, y_st = cache[key + "_pw"], cache[key + "_st"]
"""

from __future__ import annotations

import numpy as np

from .models import superover_model

__all__ = ["build_model", "lane_grid", "select_parity_lanes",
           "stress_lanes", "ref_key"]


def build_model(sweep: str, variant: str = "chain", fs: int = 44100):
    """The Super Over of a sweep (``bench.py`` ``_build_model``): pots as
    lane inputs for ``"pots"``, all pots fixed for ``"level"``; the
    ``"chain"`` variant adds the stiff vb bias source (the reference's
    simplified, chain-decomposed circuit)."""
    vb = variant == "chain"
    if sweep == "pots":
        return superover_model(drive=None, tone=None, level=1.0, fs=fs,
                               vb_source=vb)
    return superover_model(drive=1.0, tone=1.0, level=1.0, fs=fs,
                           vb_source=vb)


def lane_grid(sweep: str, L: int):
    """The lane axis (``bench.py`` ``_lane_grid``): (levels, drive, tone,
    lane_values, runner keywords)."""
    if sweep == "pots":
        # drive x tone grid over 5%..95% pot travel (the exact end stops
        # are singular operating points; the reference warns there too)
        a = max(1, int(np.sqrt(L)))
        while L % a:
            a -= 1
        b = L // a
        drive = np.repeat(np.linspace(0.05, 0.95, a), b)
        tone = np.tile(np.linspace(0.05, 0.95, b), a)
        return (None, drive, tone, np.stack([drive, tone], axis=1),
                dict(lane_input_idx=(1, 2)))
    levels = np.linspace(0.1, 2.0, L)
    return levels, None, None, levels[:, None], dict(lane_scale_idx=(0,))


def select_parity_lanes(L, K, stress=()):
    """Stratified parity lane sample (``bench.py`` ``_select_parity_lanes``):
    4 corners + seeded interior, plus any explicit ``stress`` lanes."""
    rng = np.random.default_rng(20260817)
    corners = [0, L - 1, L // 2, 1] if L >= 4 else list(range(L))
    interior = sorted(
        set(rng.integers(2, max(L - 2, 3), size=4 * K).tolist())
        - set(corners))[:max(0, K - len(corners))]
    return sorted(set(corners[:K]) | set(interior)
                  | set(i for i in stress if 0 <= i < L))


def stress_lanes(sweep, L):
    """Known hard lanes pinned into the parity sample (``bench.py``
    ``_stress_lanes``): the two dead-zone-traversal lanes of the pots
    grid; none for the level sweep."""
    if sweep == "pots" and L >= 64:
        return [int(0.78711 * L), int(0.80713 * L)]
    return []


def ref_key(sweep, variant, fs, T, reps, level, drive, tone, powerup=None):
    """Key prefix of one lane's references in ``.hostref_cache.npz``
    (``bench.py`` ``_parity_refs``); ``+ "_pw"`` is window 1 and
    ``+ "_st"`` window ``2 + reps`` of the bench's protocol (power-up, one
    warm-up window, ``reps`` timed windows).  ``level``, ``drive`` and
    ``tone`` are 1.0 where the sweep does not vary them."""
    tag = "_steady" if powerup == "steady" else ""
    ver = "scan2" if variant == "full" and sweep != "pots" else "scan3"
    return ("{}_{}_{}_fs{}_T{}_r{}_lv{:.6f}_d{:.6f}_t{:.6f}{}"
            .format(ver, sweep, variant, fs, T, reps, level, drive, tone,
                    tag))
