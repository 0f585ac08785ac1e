"""The card's idle ms a served chunk while the serving loop's host work
runs (`cli/roi_analysis.py`'s ranges "serve pad", "serve to card", "serve
to host", "serve assemble"): the traced sub-window less the union of the
device's intervals, inside the union of those ranges."""

from port_bench.spans import ms_per_unit

SPANS = ("serve pad", "serve to card", "serve to host", "serve assemble")


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    return ms_per_unit(ctx.trace, SPANS, idle=True)
