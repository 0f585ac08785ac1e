"""Set-up seconds: from the start of the process's run to the start of the
window (imports, the card, the kernels' load or build, weights and
inputs, the warm-up chunk or the first steps), on the host's clock."""


def read(ctx):
    return ctx.setup_s
