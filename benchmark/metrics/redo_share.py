"""redo_share: of the window's subsystem solves in the fused kernel, the
share whose fast path failed its keep test and took the redo, in %.  The
kernel's own counters (acme_tpu_torch.trace, on while the profiler
records): redos over solves."""

import sys


def read(run):
    rec = sys.modules.get("acme_tpu_torch.trace")
    c = rec.counters() if rec is not None else {}
    if not c.get("solves"):
        return None
    return 100.0 * c["redos"] / c["solves"]
