"""block_p95_ms: the 95th percentile, over every block of the window, of
one run() call's latency, from the call to its synchronised return
(linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if not run.blocks:
        return None
    return float(np.percentile([b["wall_s"] * 1e3 for b in run.blocks], 95))
