"""The training step's share of the card's peak: the reference step's
FLOPs, forward and backward (`torch.utils.flop_counter` at the cell's
shapes), times the window's steps a second, over the peak of the
configuration's stated precision (`roofline.peak_flops`), in %."""

from port_bench.roofline import peak_flops


def read(ctx):
    if ctx.kind != "train_steps" or not ctx.flops_per_unit:
        return None
    rate = ctx.window["steps"] / ctx.window["window_s"]
    return 100.0 * ctx.flops_per_unit * rate / peak_flops(ctx.cfg)
