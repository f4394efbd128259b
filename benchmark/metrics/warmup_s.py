"""warmup_s: the host clock around the warm-up calls: library build or
load, the power-up sibling's block, one production block."""


def read(run):
    return run.spans.get("warmup")
