"""window_mfu: the window's fixed work (work.py) over its wall seconds,
as a share of the card's float32 peak, in %."""


def read(run):
    if run.window_s <= 0 or run.peaks is None:
        return None
    return 100.0 * run.flops / run.window_s / run.peaks["float32_flops"]
