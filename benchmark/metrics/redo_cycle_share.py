"""redo_cycle_share: the fused kernel's cycles in the redo tier (the
robust path -- gated Newton, homotopy, df rescue -- and its polish pass,
the warp's wait for its lanes that take it included) over the lanes'
whole launch cycles, in %.  The kernel's own clock64 counters
(acme_tpu_torch.trace, on while the profiler records)."""

import sys


def read(run):
    rec = sys.modules.get("acme_tpu_torch.trace")
    c = rec.counters() if rec is not None else {}
    if not c.get("total"):
        return None
    return 100.0 * c["redo"] / c["total"]
