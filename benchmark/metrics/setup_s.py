"""setup_s: from the harness's start to the first timed call: imports,
model build, runner preparation and warm-up (library build or load, the
power-up block, one production block)."""


def read(run):
    return run.spans.get("setup")
