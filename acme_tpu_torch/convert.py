"""Moving runner state between the JAX package and the port.

The model is built once (``DiscreteModel``) and shared, so the only thing
that needs converting is the runner state: the JAX package keeps it as
(n, S, 128) arrays (lane l at [:, l // 128, l % 128]), the port as (n, L)
tensors, under the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fused import STATE_KEYS

__all__ = ["state_from_jax", "state_to_jax", "load_steady_seed"]


def state_from_jax(state, device="cpu"):
    """(n, S, 128) arrays (numpy or jax) -> (n, L) float32 tensors."""
    out = {}
    for k in STATE_KEYS:
        a = np.array(state[k], np.float32)
        out[k] = torch.as_tensor(
            np.ascontiguousarray(a.reshape(a.shape[0], -1)), device=device)
    return out


def state_to_jax(state, lane_block: int = 128):
    """(n, L) tensors -> (n, S, 128) float32 numpy arrays (L a multiple of
    128), ready for ``jnp.asarray``."""
    out = {}
    for k in STATE_KEYS:
        a = state[k].detach().cpu().numpy().astype(np.float32)
        n, L = a.shape
        if L % lane_block:
            raise ValueError(f"lanes ({L}) must be a multiple of "
                             f"{lane_block} for the JAX layout")
        out[k] = np.ascontiguousarray(a.reshape(n, L // lane_block,
                                                lane_block))
    return out


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
