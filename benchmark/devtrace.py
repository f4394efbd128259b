"""The traced run's device time, from ``torch.profiler``'s events.

    busy_s, ops, gaps = devtrace.reduce(prof.events(), skip=span_names)

The profiler runs over the window alone.  ``busy_s``: the union of the
device operations' intervals, the result line's ``device.busy_s``;
``ops``: device time by operation name, largest first; ``gaps``: the
longest idle stretches between device operations, each named by the
host operation that was running at its middle (the innermost one), or
"host" where none was.
"""

from __future__ import annotations

__all__ = ["reduce"]

TOP = 10        # entries in each list of the result line's breakdown


def _is_device(evt):
    dt = getattr(evt, "device_type", None)
    return dt is not None and str(dt).endswith(("CUDA", "cuda"))


def reduce(events, skip=()):
    """(busy_s, [(name, seconds)], [(name, seconds)]) of the profiler's
    events; ``skip``: the names of the host spans, whose shadows on the
    device's timeline are left out."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        a, b = float(tr.start), float(tr.end)
        if _is_device(e):
            # a host span's shadow on the device's timeline is no operation
            if not getattr(e, "is_user_annotation", False) \
                    and e.name not in skip:
                dev.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
    if not dev:
        return 0.0, [], []
    dev.sort()
    busy = 0.0
    gaps = []
    cur_a, cur_b = dev[0][0], dev[0][1]
    by_name = {}
    for a, b, name in dev:
        # a kernel's name without its template arguments
        short = name.split("<", 1)[0].strip()[:160]
        by_name[short] = by_name.get(short, 0.0) + (b - a)
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
        named.append((name, (b - a) * 1e-6))
    return busy * 1e-6, [(n, s * 1e-6) for n, s in ops], named
