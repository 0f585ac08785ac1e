"""The card's idle ms a step (an AI-DEAL pair) while the trainer loop
body makes the batch (the ranges "batch gather", "batch augment", "batch
te draw", "batch to card"): the traced sub-window less the union of the
device's intervals, inside the union of those ranges."""

from port_bench.spans import ms_per_unit

SPANS = ("batch gather", "batch augment", "batch te draw", "batch to card")


def read(ctx):
    if ctx.kind != "train_steps" or ctx.trace is None:
        return None
    return ms_per_unit(ctx.trace, SPANS, idle=True)
