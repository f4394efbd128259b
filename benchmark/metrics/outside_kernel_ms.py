"""outside_kernel_ms: per run() call of the window, its wall ms less the
ms of the kernel launches it made (CUDA events around each launch), then
the mean over the calls."""

import numpy as np


def read(run):
    rows = [b["wall_s"] * 1e3 - b["kernel_ms"] for b in run.blocks
            if b.get("kernel_ms") is not None]
    return float(np.mean(rows)) if rows else None
