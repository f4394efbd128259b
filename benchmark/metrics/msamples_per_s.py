"""msamples_per_s: every lane-sample completed in the window over the
window's wall seconds, in millions (the host clock, from the first timed
call to the return of the last)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.lane_samples / run.window_s / 1e6
