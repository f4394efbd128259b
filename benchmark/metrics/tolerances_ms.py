"""tolerances_ms: per FusedRunner.run call of the window, the host ms in
its acme.lane_tolerances spans (the per-lane tolerances and gates, numpy),
mean over the calls.  The port's own spans (acme_tpu_torch.trace, on while
the profiler records), by call as its per_run() gives them: a call is a
closed acme.run span that no other encloses."""

import sys


def read(run):
    rec = sys.modules.get("acme_tpu_torch.trace")
    calls = rec.per_run() if rec is not None else {}
    if not calls.get("runs"):
        return None
    return calls["span_ms"].get("acme.lane_tolerances", 0.0)
