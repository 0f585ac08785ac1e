"""The per-voxel IDEAL kernels' share of their roofline: the bytes bound
(`roofline.ideal_bound_s`, HBM at 3.35 TB/s) of the calls a served chunk
makes, times the traced sub-window's served chunks, over the device time of the
fit, cycle and synthesis kernels in it, in %. Nothing where the path
launches none."""

from port_bench.roofline import ideal_bound_s


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    s = ctx.trace.seconds_by("ideal")
    if s <= 0 or not ctx.calls[1]:
        return None
    return 100.0 * ideal_bound_s(ctx.calls[1]) * ctx.trace.units / s
