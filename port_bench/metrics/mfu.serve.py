"""The served path's share of the card's peak: the reference forward's
FLOPs a served slice (`torch.utils.flop_counter` at the cell's shapes,
padding not counted) times the window's served slices a second, over the
peak of the configuration's stated precision (`roofline.peak_flops`), in
%."""

from port_bench.roofline import peak_flops


def read(ctx):
    if ctx.kind != "serve_volumes" or not ctx.flops_per_unit:
        return None
    per_slice = ctx.flops_per_unit / ctx.cfg["infer_batch"]
    rate = ctx.window["slices"] / ctx.window["window_s"]
    return 100.0 * per_slice * rate / peak_flops(ctx.cfg)
