"""host_self_ms: per FusedRunner.run call of the window, its host ms less
the ms it waits for the card (its acme.wait spans: the two device-to-host
reads of the output check), mean over the calls.  The port's own spans
(acme_tpu_torch.trace, on while the profiler records), by call as its
per_run() gives them: a call is a closed acme.run span that no other
encloses."""

import sys


def read(run):
    rec = sys.modules.get("acme_tpu_torch.trace")
    calls = rec.per_run() if rec is not None else {}
    return calls.get("host_self_ms")
