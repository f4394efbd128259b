"""Moving runner state between the JAX package and the port.

Both packages build the same ``DiscreteModel``, so what needs converting
is what a runner carries per lane: its state, and for a multi-model runner
its (hi, lo) coefficient tables.  The JAX package's fused runner keeps
them as (n, S, 128) arrays (lane l at [:, l // 128, l % 128]), the port as
(n, L) tensors, the state under the same keys.  The scan engine's state is
``{"x": (L, nx), "warms": (WarmStart(p, z, dzdp), ...)}`` in both.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fused import _ZERO_FILLED, STATE_KEYS

__all__ = ["state_from_jax", "state_to_jax", "coef_from_jax", "coef_to_jax",
           "load_steady_seed", "engine_state_from_jax", "engine_state_to_jax"]


def _from_blocks(a, device):
    a = np.array(a, np.float32)
    return torch.as_tensor(np.ascontiguousarray(a.reshape(a.shape[0], -1)),
                           device=device)


def _to_blocks(t, lane_block):
    a = t.detach().cpu().numpy().astype(np.float32)
    n, L = a.shape
    if L % lane_block:
        raise ValueError(f"lanes ({L}) must be a multiple of {lane_block} "
                         "for the JAX layout")
    return np.ascontiguousarray(a.reshape(n, L // lane_block, lane_block))


def state_from_jax(state, device="cuda"):
    """(n, S, 128) arrays (numpy or jax) -> (n, L) float32 tensors on
    ``device`` (the card unless the caller asks for the CPU).  ``zlo`` and
    ``pmode`` may be missing, as the JAX runner takes them: the port's
    runner then fills them with zeros too (their rows are the model's)."""
    return {k: _from_blocks(state[k], device) for k in STATE_KEYS
            if k in state or k not in _ZERO_FILLED}


def state_to_jax(state, lane_block: int = 128):
    """(n, L) tensors -> (n, S, 128) float32 numpy arrays (L a multiple of
    128), ready for ``jnp.asarray``; a missing ``zlo`` or ``pmode`` stays
    missing."""
    return {k: _to_blocks(state[k], lane_block) for k in STATE_KEYS
            if k in state or k not in _ZERO_FILLED}


def coef_from_jax(hi, lo, device="cuda"):
    """The JAX runner's ``_coef_tables(S)`` pair, (nvar, S, 128) each, as
    the port's (nvar, L) float32 tensors (``fused_step``'s ``coef``) on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _from_blocks(hi, device), _from_blocks(lo, device)


def coef_to_jax(hi, lo, lane_block: int = 128):
    """The port's ``_coef_tables(L)`` pair as (nvar, S, 128) float32 numpy
    arrays."""
    return _to_blocks(hi, lane_block), _to_blocks(lo, lane_block)


def load_steady_seed(path, tag, runner, lanes=None):
    """Load committed per-lane steady seeds (``{tag}_{key}`` in the npz at
    ``path``, JAX layout) as the runner's state, and install the seeds'
    certified residual floors on the runner, as the JAX bench does.

    ``lanes`` optionally selects a subset of lane indices.  Returns the
    state dict of (n, L) tensors on the runner's device."""
    with np.load(path) as cache:
        missing = [k for k in STATE_KEYS + ("floors",)
                   if f"{tag}_{k}" not in cache]
        if missing:
            raise KeyError(f"steady seed {tag!r} not in {path}: "
                           f"missing {missing}")
        raw = {k: np.asarray(cache[f"{tag}_{k}"], np.float32)
               for k in STATE_KEYS}
        floors = np.asarray(cache[f"{tag}_floors"])
    state = state_from_jax(raw, device=runner.device)
    if lanes is not None:
        idx = torch.as_tensor(np.asarray(lanes), device=runner.device)
        state = {k: v[:, idx].contiguous() for k, v in state.items()}
        floors = floors[np.asarray(lanes)]
    runner._steady_floors = floors
    return state


def engine_state_from_jax(state, device="cuda", dtype=torch.float64):
    """A JAX scan-engine state (its arrays numpy or jax) as the port's:
    tensors of ``dtype`` on ``device`` (the card unless the caller asks for
    the CPU), the warm starts as the port's ``WarmStart``."""
    from .ops.newton import WarmStart
    T = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return {"x": T(state["x"]),
            "warms": tuple(WarmStart(*(T(v) for v in w))
                           for w in state["warms"])}


def engine_state_to_jax(state, warm_type=None):
    """The port's scan-engine state as numpy arrays, each warm start a
    ``warm_type`` (the JAX package's ``acme_tpu.ops.newton.WarmStart``,
    which its scan needs; by default the port's) of (p, z, dzdp)."""
    from .ops.newton import WarmStart
    warm_type = warm_type or WarmStart
    N = lambda t: t.detach().cpu().numpy()
    return {"x": N(state["x"]),
            "warms": tuple(warm_type(*(N(v) for v in w))
                           for w in state["warms"])}
