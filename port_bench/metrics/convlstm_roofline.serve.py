"""The ConvLSTM kernels' share of their roofline: the least time of the
ConvLSTM calls a served chunk makes (`roofline.convlstm_bound_s` at the
configuration's stated peak) times the traced sub-window's served chunks, over
the device time of every ConvLSTM kernel launched in it, in %."""

from port_bench.roofline import convlstm_bound_s, peak_flops


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    s = ctx.trace.seconds_by("convlstm")
    if s <= 0 or not ctx.calls[0]:
        return None
    bound = convlstm_bound_s(ctx.calls[0], peak_flops(ctx.cfg)) \
        * ctx.trace.units
    return 100.0 * bound / s
