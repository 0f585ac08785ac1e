"""Host ms a step of the trainer loop body before the copy (the shuffled
batch, the host augmentation, the TE sampling), from the harness's spans
around its calls into them over the whole window."""


def read(ctx):
    if ctx.kind != "train_steps" or not ctx.window.get("steps"):
        return None
    return ctx.window["host_s"] * 1e3 / ctx.window["steps"]
