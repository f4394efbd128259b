"""runner_prep_s: the host clock around FusedRunner(...): centering, merged
coefficients, tolerances."""


def read(run):
    return run.spans.get("runner_prep")
