"""kernel_roofline: the least time the card could take for the window's
fixed work (work.py: FLOPs at the float32 peak, or bytes at the HBM
peak, whichever is longer) over the fused kernel's time (the sum of its
launches' CUDA events), in %."""


def read(run):
    ms = sum(b["kernel_ms"] for b in run.blocks
             if b.get("kernel_ms") is not None)
    if ms <= 0 or run.peaks is None:
        return None
    least = max(run.flops / run.peaks["float32_flops"],
                run.bytes / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (ms * 1e-3)
