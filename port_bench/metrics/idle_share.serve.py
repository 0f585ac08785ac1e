"""The card's idle share over the traced sub-window of whole served chunks:
1 - (the union of the device's kernel, copy and memset intervals) / (the
window), in %."""


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
