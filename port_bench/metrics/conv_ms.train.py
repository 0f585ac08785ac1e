"""Device ms a step of cuDNN's convolution kernels (the nets), by the
kernel-name fragments of `trace.CATEGORIES`, from the traced
sub-window."""


def read(ctx):
    if ctx.kind != "train_steps" or ctx.trace is None:
        return None
    s = ctx.trace.seconds_by("convolutions")
    return s * 1e3 / ctx.trace.units if s > 0 else None
