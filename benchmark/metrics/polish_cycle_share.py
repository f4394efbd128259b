"""polish_cycle_share: the fused kernel's cycles in the polish tier (pass 0
of the polish loop with its verdict and fold passes, up to the keep test)
over the lanes' whole launch cycles, in %.  The kernel's own clock64
counters (acme_tpu_torch.trace, on while the profiler records)."""

import sys


def read(run):
    rec = sys.modules.get("acme_tpu_torch.trace")
    c = rec.counters() if rec is not None else {}
    if not c.get("total"):
        return None
    return 100.0 * c["polish"] / c["total"]
