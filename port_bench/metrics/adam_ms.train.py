"""Device ms a step inside the optimizer's profiler range "adam step"
(`train/common.py::STEP_RANGE`), from the traced sub-window."""


def read(ctx):
    if ctx.kind != "train_steps" or ctx.trace is None:
        return None
    s = ctx.trace.seconds_in_range("adam step")
    return s * 1e3 / ctx.trace.units if s > 0 else None
