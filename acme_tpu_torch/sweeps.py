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

The bench runs every sweep in one configuration of ``FusedRunner``, its
production configuration (``PRODUCTION``; the runner's own defaults are
the JAX package's, the robust path every sample), and with
``--compare-verdicts`` the main path again under two stronger verdict
tiers (``VERDICT_TIERS``).

    fr = FusedRunner(model, **PRODUCTION, **cfg, powerup="safe")

Beside them, the presets sweep, which the bench does not have: a handful
of knob presets of the pedal (fixed drive and tone, one model each, run as
the per-lane models of one ``FusedRunner``) over the whole range of input
levels.

    models = build_presets()                  # 8 models, in worker processes
    levels, drive, tone, lane_values, cfg = lane_grid("presets", 4096)
    # lane i runs models[i % 8] at input level levels[i]
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from fractions import Fraction

import numpy as np

from .model import model_matrices
from .models import superover, superover_model

__all__ = ["build_model", "build_models", "build_presets", "model_spec",
           "preset_spec", "PRESETS", "PRODUCTION", "VERDICT_TIERS",
           "lane_grid", "select_parity_lanes", "stress_lanes", "ref_key"]

# the bench's production configuration of the runner (bench.py:353-362 at
# its flags' defaults): one unguarded Newton step, a plain polish loop with
# a two-step unrolled prefix, a compensated verdict with df solves on the
# ill-conditioned subsystems, and the robust path redone only for the
# lanes that fail the keep test
PRODUCTION = dict(newton_iters=192, tol=1e-9, fast_iters=1,
                  df_polish="comp_final", fast_verify="merge",
                  polish_only=False, polish_fixed=2, verdict_refine=None,
                  verdict_jac="df", df_solve="auto")

# ``bench.py --compare-verdicts`` (bench.py:706-731): the main path again
# under the full-df verdict, and under the full-df verdict with a df
# elimination on every subsystem, each over PRODUCTION
VERDICT_TIERS = {"plainfinal": dict(df_polish="plain_final"),
                 "dfsolve": dict(df_polish="plain_final", df_solve=True)}

# the presets sweep's (drive, tone) pairs: interior pot positions (an end
# stop changes the circuit's topology), all with the level model's
# decomposition (nn [2, 3, 2], np [2, 1, 2])
PRESETS = tuple((d, t) for d in (0.25, 0.75) for t in (0.2, 0.4, 0.6, 0.8))


def _matrices(spec):
    kw = dict(spec)
    fs = kw.pop("fs", 44100)
    return model_matrices(superover(**kw), Fraction(1, int(fs)))


def build_models(specs, workers=None):
    """Super Over models for a list of ``superover_model`` keyword dicts,
    the exact part of each build (``model.model_matrices``, nearly all of
    its seconds) in a pool of ``workers`` processes (None: one per core, at
    most one per model; 1: in this process).  The models are those of
    ``superover_model(**spec)``, bit for bit.  The workers are spawned, so
    a script that calls this needs the ``if __name__ == "__main__":``
    guard."""
    specs = [dict(s) for s in specs]
    if workers is None:
        workers = min(len(specs), multiprocessing.cpu_count())
    if workers <= 1 or len(specs) <= 1:
        return [superover_model(**s) for s in specs]
    # spawned, not forked: the caller may hold a CUDA context
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        mats = list(ex.map(_matrices, specs))
    return [superover_model(matrices=m, **s) for s, m in zip(specs, mats)]


def build_presets(fs: int = 44100, presets=PRESETS, workers=None):
    """The presets sweep's models, one per (drive, tone) pair: the level
    sweep's circuit (all pots fixed, the stiff vb bias source) at other pot
    positions."""
    return build_models([preset_spec(d, t, fs) for d, t in presets], workers)


def preset_spec(drive, tone, fs: int = 44100):
    """``superover_model``'s keywords for one preset of the presets
    sweep."""
    return dict(drive=drive, tone=tone, level=1.0, vb_source=True, fs=fs)


def model_spec(sweep: str, variant: str = "chain", fs: int = 44100):
    """``superover_model``'s keywords for a sweep of the bench
    (``bench.py`` ``_build_model``)."""
    pot = None if sweep == "pots" else 1.0
    return dict(drive=pot, tone=pot, level=1.0, fs=fs,
                vb_source=variant == "chain")


def build_model(sweep: str, variant: str = "chain", fs: int = 44100):
    """The Super Over of a sweep (``bench.py`` ``_build_model``): pots as
    lane inputs for ``"pots"``, all pots fixed for ``"level"``; the
    ``"chain"`` variant adds the stiff vb bias source (the reference's
    simplified, chain-decomposed circuit)."""
    return superover_model(**model_spec(sweep, variant, fs))


def lane_grid(sweep: str, L: int):
    """The lane axis (``bench.py`` ``_lane_grid``): (levels, drive, tone,
    lane_values, runner keywords).  ``"presets"``: lane i runs preset
    ``i % len(PRESETS)`` (the runner's cyclic lane -> model rule) at input
    level ``linspace(0.1, 2.0, L // len(PRESETS))[i // len(PRESETS)]``."""
    if sweep == "presets":
        n = len(PRESETS)
        if L % n:
            raise ValueError(f"lanes ({L}) must be a multiple of {n}")
        levels = np.repeat(np.linspace(0.1, 2.0, L // n), n)
        drive, tone = (np.tile(np.array(PRESETS)[:, j], L // n)
                       for j in range(2))
        return levels, drive, tone, levels[:, None], dict(lane_scale_idx=(0,))
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
