"""Host ms a served chunk inside the serving loop's padding and assembly
ranges (`cli/roi_analysis.py`: "serve pad", the padded last chunk's
concatenation; "serve assemble", the outputs' concatenation over parts, the
trim and the volume's concatenation over chunks), from the traced
sub-window."""

from port_bench.spans import ms_per_unit

SPANS = ("serve pad", "serve assemble")


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    return ms_per_unit(ctx.trace, SPANS)
