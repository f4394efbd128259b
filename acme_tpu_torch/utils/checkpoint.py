"""State checkpoint/resume (``acme_tpu/utils/checkpoint.py``).

A runner's carry is an explicit tree of tensors: the scan engine's
``{"x", "warms": (WarmStart, ...)}`` and the fused runner's flat dict of
(n, L) tensors.  ``save_state`` writes its leaves to one .npz under the
JAX package's keys (the path of each leaf, "/"-joined: ``x``,
``warms/0/p``, ...), so a file either package writes loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def save_state(path: str, state: dict) -> None:
    """Save a runner state (a dict tree of tensors or arrays) to an .npz
    file."""
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}{k}/", v)
        elif hasattr(obj, "_fields"):  # NamedTuple (WarmStart) before tuple
            for k in obj._fields:
                walk(f"{prefix}{k}/", getattr(obj, k))
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                walk(f"{prefix}{i}/", v)
        elif isinstance(obj, torch.Tensor):
            flat[prefix.rstrip("/")] = obj.detach().cpu().numpy()
        else:
            flat[prefix.rstrip("/")] = np.asarray(obj)

    walk("", state)
    np.savez(path, **flat)


def load_state(path: str, like: dict) -> dict:
    """Load a state saved by :func:`save_state` (here or by the JAX
    package), shaped like ``like`` (e.g. a fresh ``initial_state``): each
    leaf a tensor on ``like``'s leaf's device with its dtype."""
    with np.load(path if str(path).endswith(".npz")
                 else path + ".npz") as f:
        data = {k: f[k] for k in f.files}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            return {k: walk(f"{prefix}{k}/", v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(**{k: walk(f"{prefix}{k}/", getattr(obj, k))
                                for k in obj._fields})
        if isinstance(obj, (tuple, list)):
            vals = [walk(f"{prefix}{i}/", v) for i, v in enumerate(obj)]
            return tuple(vals) if isinstance(obj, tuple) else vals
        arr = data[prefix.rstrip("/")]
        if isinstance(obj, torch.Tensor):
            return torch.as_tensor(arr, dtype=obj.dtype, device=obj.device)
        return arr

    return walk("", like)
