"""model_build_s: the host clock around superover_model(...), the port's
compiler (exact arithmetic), in set-up."""


def read(run):
    return run.spans.get("model_build")
