"""device_idle: 1 - the fused kernel's time (the sum of its launches'
CUDA events) over the traced window's wall time, in %."""


def read(run):
    ms = [b["kernel_ms"] for b in run.blocks if b.get("kernel_ms") is not None]
    if not ms or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(ms) * 1e-3 / run.window_s)
