"""Host ms a step (an AI-DEAL pair) inside the trainer loop body's batch
ranges: "batch gather" (`train/common.py::batch_iterator`), "batch
augment" (`data/augment.py`), "batch te draw" (`train/teaug.py::sample_te`)
and "batch to card" (`parallel/mesh.py::shard_batch`, the copy), from the
traced sub-window."""

from port_bench.spans import ms_per_unit

SPANS = ("batch gather", "batch augment", "batch te draw", "batch to card")


def read(ctx):
    if ctx.kind != "train_steps" or ctx.trace is None:
        return None
    return ms_per_unit(ctx.trace, SPANS)
