"""evals_per_lane_sample: Newton evaluations per lane-sample in the
window, the sum of FusedInfo.iters over lanes and subsystems over the
lane-samples."""


def read(run):
    if run.iters is None or not run.lane_samples:
        return None
    return run.iters / run.lane_samples
